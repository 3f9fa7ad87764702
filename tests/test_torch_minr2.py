"""Kernel K6 (instance_segmentation_torch/kernels/minr2.py) against the JAX
package's ``minr2_pallas.minr2_from_cnt`` (interpret mode) and its XLA
oracle ``_shift_min_r2(cnt > 0)``, bit for bit: clustered samples, padding
slots, border pixels, an all-empty image and a slab with counts but no valid
sample. On the CPU the wrapper runs its plain twin; the tests marked
``cuda`` hold the kernel against the twin on a card, on these cases, on edge
shapes and at the train cell's and the full resolution's shapes, and the
count route's (cnt, r2) at full resolution against K2's:

    python -m pytest --noconftest -m cuda tests/test_torch_minr2.py
"""

import numpy as np
import pytest
import torch

from instance_segmentation_torch.kernels import minr2 as tm2
from instance_segmentation_torch.kernels import rasterize as trz
from instance_segmentation_torch.losses import losses as tl
from instance_segmentation_torch.ops.targets import generate_targets
from instance_segmentation_torch.training.synthetic import bench_train_batch, fullres_batch

from torch_cases import FULLRES_SHAPE, TRAIN_SHAPE
from torch_cases import cuda_device  # noqa: F401 (a fixture)


def cnt_fixture(b=2, m=6, h=64, w=128, n_real=3, seed=0):
    """As tests/test_minr2_pallas.py: clustered samples in the first
    ``n_real`` slots of each image, padding slots after them, and samples on
    two corner pixels. Returns (cnt u16, has bool) numpy."""
    rng = np.random.default_rng(seed)
    cnt = np.zeros((b, m, h, w), np.uint16)
    for i in range(b):
        for j in range(n_real):
            cy, cx = rng.uniform(4, h - 4), rng.uniform(4, w - 4)
            ys = np.clip(cy + rng.normal(0, 8, 40), 0, h - 1).astype(int)
            xs = np.clip(cx + rng.normal(0, 12, 40), 0, w - 1).astype(int)
            np.add.at(cnt[i, j], (ys, xs), 1)
    cnt[0, 0, 0, 0] += 1
    cnt[0, 0, h - 1, w - 1] += 1
    return cnt, cnt.reshape(b, m, -1).sum(-1) > 0


def _empty_image():
    cnt, has = cnt_fixture()
    cnt[1], has[1] = 0, False
    return cnt, has


def _counts_without_has():
    """Slab (0, 1) holds samples but its instance is marked as having none:
    the slab must come out all 200."""
    cnt, has = cnt_fixture()
    has[0, 1] = False
    return cnt, has


CASES = {"clustered": cnt_fixture, "empty_image": _empty_image,
         "counts_without_has": _counts_without_has}


@pytest.fixture
def interpret():
    import instance_segmentation_tpu.losses.minr2_pallas as m2p
    old = m2p.INTERPRET
    m2p.INTERPRET = True
    yield m2p
    m2p.INTERPRET = old


@pytest.mark.parametrize("case", list(CASES))
def test_minr2_twin_matches_pallas_and_xla_bitwise(case, interpret):
    import jax.numpy as jnp
    from instance_segmentation_tpu.losses.losses import _shift_min_r2
    cnt, has = CASES[case]()
    got = tm2.minr2_from_cnt(torch.from_numpy(cnt.astype(np.int16)).view(torch.uint16),
                             torch.from_numpy(has))
    assert got.dtype == torch.uint8 and tuple(got.shape) == cnt.shape
    pallas = np.asarray(interpret.minr2_from_cnt(jnp.asarray(cnt),
                                                 jnp.asarray(has.astype(np.float32))))
    np.testing.assert_array_equal(got.numpy(), pallas)
    oracle = np.asarray(_shift_min_r2(jnp.asarray(cnt) > 0))
    oracle = np.where(has[..., None, None], oracle, 200)
    np.testing.assert_array_equal(got.numpy(), oracle)
    assert (got.numpy()[~has] == 200).all()
    if case == "counts_without_has":
        assert cnt[0, 1].any() and (got[0, 1] == 200).all()


def test_minr2_twin_matches_the_rasterizer_on_points():
    """On a point list both routes give one min-r2 map: K2's, and the count
    map's followed by K6."""
    from test_torch_losses import scattered_points
    pts, val, h, w = scattered_points()
    pts_t, val_t = torch.from_numpy(pts), torch.from_numpy(val)
    cnt, r2, _ = trz.rasterize_cnt_r2(pts_t, val_t, h, w)
    assert torch.equal(tm2.minr2_from_cnt(cnt, val_t.any(dim=2)), r2)


def test_minr2_wrapper_checks_and_counts_no_cpu_launch():
    cnt, has = cnt_fixture()
    cnt_t = torch.from_numpy(cnt.astype(np.int16)).view(torch.uint16)
    has_t = torch.from_numpy(has)
    before = dict(tm2.launches)
    u8 = tm2.minr2_from_cnt(cnt_t, has_t.to(torch.uint8))
    assert torch.equal(u8, tm2.minr2_from_cnt_plain(cnt_t, has_t))
    assert tm2.launches == before
    with pytest.raises(ValueError, match="cnt"):
        tm2.minr2_from_cnt(cnt_t.view(torch.int16), has_t)
    with pytest.raises(ValueError, match="has"):
        tm2.minr2_from_cnt(cnt_t, has_t[:, :2])
    with pytest.raises(ValueError, match="multiple of 4"):
        tm2.minr2_from_cnt(cnt_t[..., :126], has_t)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tm2.minr2_from_cnt(cnt_t.view(torch.int16).to("meta").view(torch.uint16),
                           has_t.to("meta"))


@pytest.mark.cuda
def test_minr2_kernel_matches_twin_on_card(cuda_device):
    dev = cuda_device
    for case, make in CASES.items():
        cnt, has = make(h=70, w=260) if case == "clustered" else make()
        cnt_t = torch.from_numpy(cnt.astype(np.int16)).to(dev).view(torch.uint16)
        has_t = torch.from_numpy(has).to(dev)
        before = tm2.launches["minr2_from_cnt"]
        got = tm2.minr2_from_cnt(cnt_t, has_t)
        want = tm2.minr2_from_cnt_plain(cnt_t, has_t)
        torch.cuda.synchronize()
        assert tm2.launches["minr2_from_cnt"] == before + 1
        assert torch.equal(got, want), case


def _edge_counts(b, m, h, w, seed):
    """Sparse counts with samples on all four borders of slab (0, 0), and
    slab (-1, -1) holding counts with has == 0."""
    rng = np.random.default_rng(seed)
    cnt = ((rng.uniform(size=(b, m, h, w)) < 0.003) * rng.integers(1, 4, (b, m, h, w)))
    cnt[0, 0, [0, h - 1], :] = 1
    cnt[0, 0, :, [0, w - 1]] = 2
    cnt[-1, -1, h // 2, w // 2] = 5
    has = cnt.reshape(b, m, -1).any(-1)
    has[-1, -1] = False
    return cnt.astype(np.int16), has


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,h,w", [
    (2, 3, tm2.BAND_H + 6, 2 * tm2.BAND_W + 4),      # H, W off the band; W % 8 == 4
    (1, 4, 2 * tm2.BAND_H + 2, tm2.BAND_W + 72),     # W % 8 == 0, not of BAND_W
    (3, 2, tm2.BAND_H - 1, 12),                       # one band, narrower than one
])
def test_minr2_kernel_matches_twin_on_edge_shapes(cuda_device, b, m, h, w):
    """Bands and count vectors that end raggedly, samples on the borders, a
    slab with counts but has == 0, and the same batch as padding only."""
    dev = cuda_device
    cnt, has = _edge_counts(b, m, h, w, seed=h + w)
    cnt_t = torch.from_numpy(cnt).to(dev).view(torch.uint16)
    for flags in (torch.from_numpy(has).to(dev), torch.zeros((b, m), dtype=torch.bool,
                                                              device=dev)):
        got = tm2.minr2_from_cnt(cnt_t, flags)
        want = tm2.minr2_from_cnt_plain(cnt_t, flags)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert (got == 200).all()


def _cell_targets(dev, where):
    """The targets of the train cell's labels (B=8, M=96, P=1024, 512x1024,
    with a border-clipped instance and an image without labels) or of the
    full-resolution batch (B=1, 1024x2048), and (H, W)."""
    if where == "train cell":
        b, m, p, h, w = TRAIN_SHAPE
        labels = bench_train_batch(b, m, h, w, edge_cases=True)[1]
    else:
        b, m, p, h, w = FULLRES_SHAPE
        labels = fullres_batch(b, m, h, w)[1]
    t = generate_targets(*(torch.from_numpy(a).to(dev) for a in labels), h, w, max_points=p,
                         dense_kp=False)
    return t, (h, w)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["train cell", "full resolution"])
def test_minr2_kernel_matches_twin_at_the_cells_shapes_on_card(cuda_device, where):
    """Bitwise on the count map of the cell's targets; at full resolution
    also with a live slab marked as having no sample (all 200 there), and
    the count route's (cnt, r2) bitwise equal to K2's."""
    t, (h, w) = _cell_targets(cuda_device, where)
    cnt = tl.ae_sample_count(t, h, w)
    has = t.pt_valid.any(dim=2)
    got = tm2.minr2_from_cnt(cnt, has)
    assert got.dtype == torch.uint8 and torch.equal(got, tm2.minr2_from_cnt_plain(cnt, has))
    if where == "full resolution":
        slot = int(has[0].nonzero()[0])
        assert bool(cnt.view(torch.int16)[0, slot].any())
        has_off = has.clone()
        has_off[0, slot] = False
        off = tm2.minr2_from_cnt(cnt, has_off)
        assert torch.equal(off, tm2.minr2_from_cnt_plain(cnt, has_off))
        assert bool((off[0, slot] == 200).all())
        k2 = trz.rasterize_cnt_r2(t.points, t.pt_valid, h, w)
        assert torch.equal(k2[0].view(torch.int16), cnt.view(torch.int16))
        assert torch.equal(k2[1], got)
