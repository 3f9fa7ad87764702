"""The collectives of the spatial (image-W) mesh axis, and the context that
turns them on.

Under the JAX package's ``("data", "spatial")`` mesh, GSPMD splits the
frames' W axis over the spatial devices and XLA inserts what a W-split
forward needs. The port writes those out. Inside ``sharded(mesh)`` (with
``mesh.spatial > 1``) the model's layers see their rank's W slab of the
activations and call:

* ``halo_exchange``: a slab padded with its neighbours' edge columns, and
  with zeros at the image's edges (the convolutions; ``models/layers.py``);
* ``all_reduce_sum``: a float32 sum over the spatial group (the
  squeeze-and-excitation means; ``models/efficientnet.py``);
* ``gather_w``: the slabs concatenated along W in rank order (the pyramid
  before the BiFPN, the counterpart of ``pin_data_sharding``, and the dense
  heads before the decode; ``models/efficientseg.py``).

All three are ``all_reduce`` calls, because gloo takes no other collective
on CUDA tensors and NCCL takes it too; so one code path serves both
backends. An exchange or a gather writes this rank's part into its slot of
a zero buffer that holds every rank's slot, and sums the buffer over the
group: each element has one nonzero term, so the sum is exact, save that
a -0.0 comes back as +0.0 (no later op tells them apart but a division by
zero, and the forward divides by none of these values). ``calls`` counts
each kind per call.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from instance_segmentation_torch.parallel.mesh import Mesh

calls = {"halo": 0, "all_reduce": 0, "gather": 0}
_active: Optional[Mesh] = None


@contextlib.contextmanager
def sharded(mesh: Optional[Mesh]):
    """While open, the layers take their input as ``mesh``'s W slabs (None,
    or a mesh with one spatial rank: the plain one-device forward)."""
    global _active
    before = _active
    _active = mesh if mesh is not None and mesh.spatial > 1 else None
    try:
        yield
    finally:
        _active = before


def active() -> Optional[Mesh]:
    """The mesh whose W slabs the layers now see, or None."""
    return _active


def conv_halo(width: int, kernel: int, stride: int, pad_left: int, layer: str
              ) -> Tuple[int, int]:
    """(left, right) columns a slab ``width`` wide needs from its neighbours
    for a conv whose global W padding starts with ``pad_left``: the conv of
    the padded image, cut at the slab's output columns, reads ``pad_left``
    columns before the slab and ``kernel - stride - pad_left`` after it.
    Raises a ValueError naming ``layer`` when the slab's start is not on the
    stride or a neighbour's slab is narrower than the halo."""
    left, right = pad_left, kernel - stride - pad_left
    if width % stride:
        raise ValueError(f"{layer}: a W slab of {width} columns does not start on the stride "
                         f"{stride} of this layer (W must be divisible by spatial ranks x "
                         "the product of the strides before it)")
    if right < 0:
        raise ValueError(f"{layer}: stride {stride} exceeds kernel {kernel} - pad {pad_left}")
    if max(left, right) > width:
        raise ValueError(f"{layer}: a halo of {max(left, right)} columns exceeds the "
                         f"neighbour's W slab of {width}")
    return left, right


def _sum(buf: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    dist.all_reduce(buf, group=mesh.spatial_group)
    return buf


def halo_exchange(x: torch.Tensor, left: int, right: int, mesh: Mesh) -> torch.Tensor:
    """[B, C, H, w] slab -> [B, C, H, left + w + right]: the left neighbour's
    last ``left`` columns, the slab, the right neighbour's first ``right``
    columns; zeros where the image ends (the first rank's left, the last
    rank's right)."""
    calls["halo"] += 1
    s, n = mesh.spatial_index, mesh.spatial
    w = x.shape[-1]
    buf = x.new_zeros((n, *x.shape[:-1], left + right))
    buf[s, ..., :left] = x[..., w - left:]          # what the right neighbour takes
    buf[s, ..., left:] = x[..., :right]             # what the left neighbour takes
    buf = _sum(buf, mesh)
    edge = x.shape[:-1]
    before = buf[s - 1, ..., :left] if s > 0 else x.new_zeros((*edge, left))
    after = buf[s + 1, ..., left:] if s < n - 1 else x.new_zeros((*edge, right))
    return torch.cat([before, x, after], dim=-1)


def gather_w(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[B, C, H, w] slabs -> [B, C, H, S * w], in rank order, on every rank."""
    calls["gather"] += 1
    buf = x.new_zeros((mesh.spatial, *x.shape))
    buf[mesh.spatial_index] = x
    b, c, h, w = x.shape
    return _sum(buf, mesh).permute(1, 2, 3, 0, 4).reshape(b, c, h, mesh.spatial * w)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The float32 sum of ``x`` over the spatial group (a new tensor)."""
    calls["all_reduce"] += 1
    return _sum(x.float().clone(), mesh)


def spatial_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean over H and the whole W of [B, C, H, w] slabs, [B, C, 1, 1] in
    x's dtype: the slabs' float32 sums added over the group, over H * W."""
    h, w = x.shape[-2:]
    total = all_reduce_sum(x.float().sum(dim=(2, 3), keepdim=True), mesh)
    return (total / (h * w * mesh.spatial)).to(x.dtype)
