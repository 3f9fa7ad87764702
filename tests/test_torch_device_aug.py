"""The port's on-device augmentation (instance_segmentation_torch/ops/device_aug.py)
against the JAX package's ``random_hflip_brightness``: the port is fed the
draws (flip, gate, shift) the JAX function makes from its key, and the
frames and polygons must come out bitwise equal. The ``jax.random`` stream
itself is not reproduced: the port draws from a torch generator."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instance_segmentation_tpu.ops.device_aug import random_hflip_brightness as j_aug
from instance_segmentation_torch.models import EfficientSegConfig
from instance_segmentation_torch.ops import device_aug
from instance_segmentation_torch.ops.device_aug import (
    draw_hflip_brightness, random_hflip_brightness,
)
from instance_segmentation_torch.training.synthetic import small_train_batch
from instance_segmentation_torch.training.train_step import Trainer

B, H, W, M = 6, 16, 24, 3


def _jax_draws(key, hflip_ratio, brightness_ratio, shift_value):
    """The draws ``random_hflip_brightness`` makes from ``key`` (its own splits)."""
    k_flip, k_bshift, k_bgate = jax.random.split(key, 3)
    flip = jax.random.uniform(k_flip, (B,)) <= hflip_ratio
    gate = jax.random.uniform(k_bgate, (B,)) <= brightness_ratio
    shift = jax.random.randint(k_bshift, (B,), -shift_value, shift_value + 1)
    return tuple(torch.from_numpy(np.array(d)) for d in (flip, gate, shift))


@pytest.mark.parametrize("seed, brightness_ratio, shift_value",
                         [(0, 1.0, 10), (1, 0.5, 10), (2, 0.5, 40)])
def test_hflip_brightness_matches_jax_given_its_draws(seed, brightness_ratio, shift_value):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    images[:, :2] = 0                               # shifts clip at both ends
    images[:, 2:4] = 255
    polys = rng.uniform(-5, W + 5, (B, M, 8, 2)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want_i, want_p = j_aug(jnp.asarray(images), jnp.asarray(polys), key,
                           brightness_ratio=brightness_ratio, shift_value=shift_value)
    flip, gate, shift = _jax_draws(key, 0.5, brightness_ratio, shift_value)
    got_i, got_p = random_hflip_brightness(torch.from_numpy(images), torch.from_numpy(polys),
                                           flip, gate, shift)
    assert got_i.dtype == torch.uint8 and got_p.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    assert 0 < int(flip.sum()) < B                  # both branches taken
    if brightness_ratio < 1.0:
        assert 0 < int(gate.sum()) < B


def test_draws_are_seeded_and_in_range(monkeypatch):
    assert (device_aug.HFLIP_RATIO, device_aug.BRIGHTNESS_RATIO, device_aug.SHIFT_VALUE) == (
        0.5, 1.0, 10)                                # the reference's
    assert bool(draw_hflip_brightness(4096, torch.Generator().manual_seed(3))[1].all())
    monkeypatch.setattr(device_aug, "BRIGHTNESS_RATIO", 0.25)       # the gate's draw
    draws = [draw_hflip_brightness(4096, torch.Generator().manual_seed(3)) for _ in range(2)]
    for a, b in zip(*draws):
        assert torch.equal(a, b)
    flip, gate, shift = draws[0]
    assert flip.dtype == gate.dtype == torch.bool and shift.dtype == torch.int32
    assert abs(float(flip.float().mean()) - 0.5) < 0.05
    assert abs(float(gate.float().mean()) - 0.25) < 0.05
    assert int(shift.min()) == -10 and int(shift.max()) == 10


def test_trainer_augments_before_the_targets():
    """``Trainer(device_aug=True)`` applies the draws of its generator to the
    batch it was given, and the step runs on it."""
    h, w = 128, 256
    frames, labels = small_train_batch(2, 8, h, w, seed=4)
    cfg = EfficientSegConfig(num_classes=8, compound_coef=0, drop_connect_rate=0.0)
    trainer = Trainer(cfg, torch.Generator().manual_seed(0), (h, w), max_points=64,
                      device=torch.device("cpu"), device_aug=True, aug_seed=9)
    images, polys, _, _ = trainer._as_batch(frames, *labels)
    draws = draw_hflip_brightness(2, torch.Generator().manual_seed(9))
    want_i, want_p = random_hflip_brightness(torch.from_numpy(frames),
                                             torch.from_numpy(labels[0]), *draws)
    assert torch.equal(images, want_i) and torch.equal(polys, want_p)
    stats = trainer.step(frames, *labels)
    assert all(bool(torch.isfinite(v)) for v in stats.values())
