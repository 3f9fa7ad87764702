"""On-device augmentation: random horizontal flip and brightness shift.

Counterpart of ``instance_segmentation_tpu/ops/device_aug.py``
(``random_hflip_brightness``), run by the trainer on its device before target
generation when asked for (``Trainer(device_aug=True)``): uint8 frames in
and out, the polygons flipped with their frames.

The draws (flip, gate, shift) come from an explicit generator. The JAX
package draws them from a ``jax.random`` key, a stream torch cannot
reproduce, so ``random_hflip_brightness`` takes the draws as arguments and
``draw_hflip_brightness`` makes them. A data-parallel trainer draws for the
global batch from a generator seeded alike on every rank and takes its
slice, so N ranks augment exactly as one rank does.
"""

from __future__ import annotations

from typing import Tuple

import torch


# The reference trainer's draws (``random_hflip_brightness``'s defaults).
HFLIP_RATIO, BRIGHTNESS_RATIO, SHIFT_VALUE = 0.5, 1.0, 10


def draw_hflip_brightness(batch: int, generator: torch.Generator
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(flip bool [B], gate bool [B], shift int32 [B] in [-SHIFT_VALUE,
    SHIFT_VALUE]) on the generator's device, drawn as the reference draws
    them: flip where U <= HFLIP_RATIO, the shift applied where U <=
    BRIGHTNESS_RATIO."""
    dev = generator.device
    flip = torch.rand(batch, generator=generator, device=dev) <= HFLIP_RATIO
    gate = torch.rand(batch, generator=generator, device=dev) <= BRIGHTNESS_RATIO
    shift = torch.randint(-SHIFT_VALUE, SHIFT_VALUE + 1, (batch,), generator=generator,
                          device=dev, dtype=torch.int32)
    return flip, gate, shift


def random_hflip_brightness(images: torch.Tensor, polys: torch.Tensor, flip: torch.Tensor,
                            gate: torch.Tensor, shift: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images uint8 [B, H, W, 3]; polys f32 [B, M, V, 2] (row, col) at input
    resolution; the draws [B] of ``draw_hflip_brightness``.

    Per image: where ``flip``, the frame mirrored left-right and the polygon
    columns mapped to ``W - 1 - x`` (ref cv2_aug_transforms.py:130-148);
    then, where ``gate``, the integer ``shift`` added to every pixel, rounded
    and clipped to [0, 255] (ref :234-251)."""
    w = images.shape[2]
    images = torch.where(flip[:, None, None, None], images.flip(2), images)
    cols = torch.where(flip[:, None, None], (w - 1) - polys[..., 1], polys[..., 1])
    polys = torch.stack([polys[..., 0], cols], dim=-1)
    shift = torch.where(gate, shift, torch.zeros_like(shift)).to(torch.float32)
    out = torch.clamp(torch.round(images.to(torch.float32) + shift[:, None, None, None]),
                      0, 255)
    return out.to(torch.uint8), polys
