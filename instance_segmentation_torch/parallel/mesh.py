"""The (data, spatial) device mesh over ``torch.distributed`` ranks.

Counterpart of ``instance_segmentation_tpu/parallel/mesh.py``. The JAX
package declares a ``jax.sharding.Mesh`` with two axes and lets GSPMD place
the work:

    "data"    -- the batch split over devices;
    "spatial" -- the image W axis split over devices (XLA inserts the conv
                 halo exchanges).

Here each rank is one process on one device. ``make_mesh`` puts rank r of
the group at (data r // S, spatial r % S), as the JAX ``make_mesh`` reshapes
its device list to (data, spatial), and gives it two process groups: the
ranks of its data row (its spatial group, which splits W) and the ranks of
its spatial column (its data group). ``batch_shard`` and ``data_shard`` take
the place of ``batch_sharding`` and ``label_sharding``: they cut a rank's
share out of a global batch. ``replicated`` has no counterpart: every rank
builds the whole model from the same seed or variable tree.

The spatial axis serves the eval forward and the decode only
(``parallel/spatial.py``); training stays data-parallel, as in the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from instance_segmentation_torch.device import require_cuda
from instance_segmentation_torch.parallel.multihost import maybe_initialize


@dataclass(frozen=True)
class MeshSpec:
    data: int = -1      # -1 => fill with all remaining devices
    spatial: int = 1

    def resolve(self, n_devices: int):
        spatial = max(1, self.spatial)
        data = self.data if self.data > 0 else n_devices // spatial
        if data * spatial != n_devices:
            raise ValueError(
                f"mesh {data}x{spatial} does not cover {n_devices} devices")
        return data, spatial


@dataclass(frozen=True)
class Mesh:
    """This rank's place on a (data, spatial) grid: the axes' sizes, its
    coordinates, the process groups along each axis (None without a
    process group) and its device."""
    data: int
    spatial: int
    data_index: int
    spatial_index: int
    data_group: Optional[dist.ProcessGroup]
    spatial_group: Optional[dist.ProcessGroup]
    device: torch.device

    @property
    def rank(self) -> int:
        """This rank's index in the mesh's group (data-major)."""
        return self.data_index * self.spatial + self.spatial_index


def make_mesh(spec: MeshSpec = MeshSpec(), group=None, device: Optional[torch.device] = None,
              device_type: str = "cuda") -> Mesh:
    """The mesh ``spec`` over the ranks of ``group`` (default: every rank);
    every rank of ``group`` calls it, and only they. Without a process
    group it first joins the one torchrun describes
    (``multihost.maybe_initialize(device_type)``); without that, the mesh
    is this process alone. ``device`` defaults to the device the join
    picked, else the current CUDA device (``device_type="cpu"``: the CPU).
    Raises when the grid does not cover the group."""
    joined = None if dist.is_initialized() else maybe_initialize(device_type)
    if device is None:
        device = joined or (require_cuda() if device_type == "cuda" else torch.device("cpu"))
    if not dist.is_initialized():
        data, spatial = spec.resolve(1)
        return Mesh(data, spatial, 0, 0, None, None, torch.device(device))
    ranks = dist.get_process_group_ranks(group or dist.group.WORLD)
    data, spatial = spec.resolve(len(ranks))
    d, s = divmod(ranks.index(dist.get_rank()), spatial)
    spatial_group = dist.new_group(ranks[d * spatial:(d + 1) * spatial],
                                   use_local_synchronization=True)
    data_group = dist.new_group(ranks[s::spatial], use_local_synchronization=True)
    return Mesh(data, spatial, d, s, data_group, spatial_group, torch.device(device))


def _share(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} {n} is not divisible by {parts} ranks; "
                         "the rest would be silently dropped")
    per = n // parts
    return slice(index * per, (index + 1) * per)


def data_shard(x, mesh: Mesh):
    """This rank's slice of the leading (batch) axis of ``x`` (``label_sharding``)."""
    return x[_share(len(x), mesh.data, mesh.data_index, "global batch")]


def batch_shard(frames, mesh: Mesh):
    """This rank's share of [B, H, W, C] frames: its batch slice, and of that
    its W slab (``batch_sharding``, ``P("data", None, "spatial", None)``)."""
    w = _share(frames.shape[2], mesh.spatial, mesh.spatial_index, "image width")
    return data_shard(frames, mesh)[:, :, w]
