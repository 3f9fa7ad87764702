"""Port losses and kernels K2-K5 (instance_segmentation_torch/losses,
kernels/rasterize.py, kernels/ae_terms.py) against the JAX package on seeded
numpy inputs: B0 shapes B=2, 128x512, M=8, P=64, float32. The reference's
Pallas kernels run in interpret mode (``INTERPRET = True``, as the JAX
package's own tests run them) with ``LossConfig(ae_impl="pallas")``; K2 and
K5 are also held against the XLA oracles. On the CPU the port's wrappers run
the kernels' plain twins; the tests marked ``cuda`` hold each kernel against
its twin on a card, at these shapes and at the train cell's and the full
resolution's (K5, K3 and K4 on the route each takes there):

    python -m pytest --noconftest -m cuda tests/test_torch_losses.py
"""

import numpy as np
import pytest
import torch

from instance_segmentation_torch.kernels import ae_terms as tae
from instance_segmentation_torch.kernels import rasterize as trz
from instance_segmentation_torch.losses import losses as tl
import instance_segmentation_torch.ops.targets as tt
from instance_segmentation_torch.kernels import minr2 as tm2
from instance_segmentation_torch.training.synthetic import bench_train_batch, fullres_batch

from torch_cases import FULLRES_SHAPE, TRAIN_SHAPE
from torch_cases import cuda_device  # noqa: F401 (a fixture)

torch.set_num_threads(2)
B, H, W, M, P = 2, 128, 512, 8, 64
VALUE_TOL = dict(rtol=1e-5, atol=0.0)
GRAD_TOL = 1e-4                                 # of max|g|, as test_ae_pallas.py


def octagon_labels(seed=0, n_real=5):
    rng = np.random.default_rng(seed)
    polys = np.zeros((B, M, 8, 2), np.float32)
    n_verts = np.zeros((B, M), np.int32)
    cls_ids = np.full((B, M), -1, np.int32)
    ang = np.linspace(0, 2 * np.pi, 9)[:-1]
    for b in range(B):
        for m in range(n_real):
            cy, cx = rng.uniform(25, H - 25), rng.uniform(60, W - 60)
            rh, rw = rng.uniform(8, 22), rng.uniform(15, 45)
            polys[b, m] = np.stack([cy + rh * np.sin(ang), cx + rw * np.cos(ang)], -1)
            n_verts[b, m] = 8
            cls_ids[b, m] = rng.integers(0, 8)
        polys[b, n_real:] = polys[b, 0, 0]
    return polys, n_verts, cls_ids


def border_clipped_labels():
    """As tests/test_ae_pallas.py: instance 0 spans cols -500..60, so its
    window misses its in-image samples; instance 1 is inside; image 1 has
    no labels."""
    polys = np.zeros((B, M, 8, 2), np.float32)
    n_verts = np.zeros((B, M), np.int32)
    cls_ids = np.full((B, M), -1, np.int32)
    polys[0, 0] = [[80, 60], [110, 60], [110, -500], [80, -500]] * 2
    polys[0, 1] = [[30, 100], [30, 180], [100, 180], [100, 100]] * 2
    n_verts[0, :2] = 4
    cls_ids[0, :2] = (2, 5)
    polys[0, 2:] = polys[0, 1, 0]
    polys[1] = polys[0, 1, 0]
    return polys, n_verts, cls_ids


LABELS = {"octagons": octagon_labels, "border_clipped": border_clipped_labels,
          "empty": lambda: octagon_labels(n_real=0)}


def head_outputs(seed):
    """Random planar train heads and box outputs, numpy: kp [B,H,W], ae 4 x
    [B,H,W], tan 2 x [B,H,W], regression [B,A,4], classification [B,A,C]."""
    from instance_segmentation_torch.models import generate_anchors
    anchors = generate_anchors(H, W, pyramid_levels=(3, 4, 5, 6, 7))
    rng = np.random.default_rng(seed)
    A = anchors.shape[0]
    planes = rng.normal(0, 1, (7, B, H, W)).astype(np.float32)
    reg = rng.normal(0, 0.3, (B, A, 4)).astype(np.float32)
    cls = (1 / (1 + np.exp(-rng.normal(-3, 1.5, (B, A, 8))))).astype(np.float32)
    return planes, reg, cls, anchors


@pytest.fixture
def interpret():
    """Run the JAX package's Pallas kernels in interpret mode on the CPU."""
    import instance_segmentation_tpu.losses.ae_pallas as aep
    import instance_segmentation_tpu.losses.rasterize_pallas as rp
    old = (aep.INTERPRET, rp.INTERPRET)
    aep.INTERPRET = rp.INTERPRET = True
    yield
    aep.INTERPRET, rp.INTERPRET = old


def both_targets(labels):
    import jax
    import jax.numpy as jnp
    from instance_segmentation_tpu.ops.targets import generate_targets
    arrays = LABELS[labels]()
    want = jax.jit(lambda p, n, c: generate_targets(p, n, c, H, W, max_points=P,
                                                    dense_kp=False))(*map(jnp.asarray, arrays))
    got = tt.generate_targets(*map(torch.from_numpy, arrays), H, W, max_points=P,
                              dense_kp=False)
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    np.testing.assert_array_equal(got.pt_valid.numpy(), np.asarray(want.pt_valid))
    return got, want


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


# ---- K2 ------------------------------------------------------------------------------

@pytest.mark.parametrize("labels", list(LABELS))
def test_rasterize_cnt_r2_matches_pallas_and_xla_bitwise(labels, interpret):
    import jax.numpy as jnp
    import instance_segmentation_tpu.losses.rasterize_pallas as rp
    from instance_segmentation_tpu.losses.losses import _shift_min_r2, ae_sample_count
    got_t, want_t = both_targets(labels)
    cnt, r2, uni = trz.rasterize_cnt_r2(got_t.points, got_t.pt_valid, H, W)
    assert (cnt.dtype, r2.dtype, uni.dtype) == (torch.uint16, torch.uint8, torch.uint8)
    pallas = rp.rasterize_cnt_r2(want_t.points, want_t.pt_valid, H, W)
    for g, w in zip((cnt, r2, uni), pallas):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    cnt_x = ae_sample_count(want_t, H, W)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_x))
    np.testing.assert_array_equal(r2.numpy(), np.asarray(_shift_min_r2(cnt_x > 0)))
    np.testing.assert_array_equal(uni.numpy(), np.asarray(jnp.any(cnt_x > 0, axis=1)))


def scattered_points(seed=0, n_real=3, b=2, m=6, p=64, h=64, w=128):
    """Points scattered around random centers, many outside the image (the
    clip rule) and duplicated pixels (counts > 1), as
    tests/test_rasterize_pallas.py."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((b, m, p, 2), np.int32)
    val = np.zeros((b, m, p), bool)
    for i in range(b):
        for j in range(n_real):
            cy, cx = rng.uniform(4, h - 4), rng.uniform(4, w - 4)
            pts[i, j, :40, 0] = (cy + rng.normal(0, 20, 40)).astype(np.int32)
            pts[i, j, :40, 1] = (cx + rng.normal(0, 30, 40)).astype(np.int32)
            val[i, j, :40] = True
            pts[i, j, 1] = pts[i, j, 0]
    return pts, val, h, w


def test_rasterize_cnt_r2_clips_and_counts_as_the_scatter():
    import jax.numpy as jnp
    from instance_segmentation_tpu.losses.losses import _shift_min_r2, ae_sample_count
    from instance_segmentation_tpu.ops.targets import Targets
    pts, val, h, w = scattered_points()
    cnt, r2, uni = trz.rasterize_cnt_r2(torch.from_numpy(pts), torch.from_numpy(val), h, w)
    stub = Targets(det_ann=None, centers=None, inst_valid=None, normals=None, kp_tgt=None,
                   points=jnp.asarray(pts), pt_valid=jnp.asarray(val))
    cnt_x = np.asarray(ae_sample_count(stub, h, w))
    assert cnt_x.max() > 1
    np.testing.assert_array_equal(cnt.numpy(), cnt_x)
    np.testing.assert_array_equal(r2.numpy(), np.asarray(_shift_min_r2(jnp.asarray(cnt_x > 0))))
    np.testing.assert_array_equal(uni.numpy(), (cnt_x > 0).any(axis=1).astype(np.uint8))


# ---- K5 ------------------------------------------------------------------------------

def _scatter_oracle(pts, val, normals, h, w):
    """The f32 scatter-add K5 replaces, in float64."""
    b_, m_, p_, _ = pts.shape
    flat = np.zeros((b_ * h * w, 2), np.float64)
    ys = np.clip(pts[..., 0], 0, h - 1)
    xs = np.clip(pts[..., 1], 0, w - 1)
    idx = (np.arange(b_)[:, None, None] * h * w + ys * w + xs)[val]
    np.add.at(flat, idx, normals[val].astype(np.float64))
    return flat.reshape(b_, h, w, 2)


def test_rasterize_nmap_matches_pallas_and_scatter(interpret):
    import jax.numpy as jnp
    import instance_segmentation_tpu.losses.rasterize_pallas as rp
    pts, val, h, w = scattered_points()
    ang = np.random.default_rng(7).uniform(0, 2 * np.pi, val.shape)
    normals = np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32)
    n0, n1 = trz.rasterize_nmap(*map(torch.from_numpy, (pts, val, normals)), h, w)
    ref = _scatter_oracle(pts, val, normals, h, w)
    pallas = rp.rasterize_nmap(*map(jnp.asarray, (pts, val, normals)), h, w)
    for c, got in enumerate((n0, n1)):
        np.testing.assert_allclose(got.numpy(), ref[..., c], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas[c]), rtol=1e-5, atol=1e-5)


def piled_points(seed, b=2, m=6, p=256, h=32, w=64):
    """Many samples piled on a few pixels (sums of up to ~100 normals per
    pixel, in an order that matters in float32), samples clipped onto the
    border, and invalid samples placed outside the image (which must count
    nowhere, not at their clipped pixel)."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.integers(-8, h + 8, (b, m, p)), rng.integers(-8, w + 8, (b, m, p))],
                   axis=-1).astype(np.int32)
    pile = rng.uniform(size=(b, m, p)) < 0.5
    pts[pile] = [h // 2, w // 3]
    val = rng.uniform(size=(b, m, p)) < 0.8
    val[:, m - 1] = False                              # a padding slot
    out = ~val & (rng.uniform(size=(b, m, p)) < 0.5)
    pts[out] = [h + 5, -7]
    ang = rng.uniform(0, 2 * np.pi, (b, m, p))
    normals = (np.stack([np.sin(ang), np.cos(ang)], -1) * rng.uniform(0.1, 3.0, (b, m, p, 1)))
    return pts, val, normals.astype(np.float32), h, w


def sequential_scatter(pts, val, normals, h, w):
    """The summed-normal planes by a float32 loop in (image, instance,
    sample) order, one add at a time."""
    b_, m_, p_, _ = pts.shape
    out = np.zeros((2, b_ * h * w), np.float32)
    for i, j, k in np.ndindex(b_, m_, p_):
        if val[i, j, k]:
            y, x = min(max(pts[i, j, k, 0], 0), h - 1), min(max(pts[i, j, k, 1], 0), w - 1)
            for c in range(2):
                out[c, (i * h + y) * w + x] += normals[i, j, k, c]
    return out.reshape(2, b_, h, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_rasterize_nmap_plain_sums_in_instance_sample_order(seed):
    """The twin (PyTorch's CPU index_add_) equals a sequential float32 scatter
    bit for bit: the order K5 keeps on the card."""
    pts, val, normals, h, w = piled_points(seed)
    want = sequential_scatter(pts, val, normals, h, w)
    got = trz.rasterize_nmap_plain(*map(torch.from_numpy, (pts, val, normals)), h, w)
    assert (want != 0).sum() > 10 and np.abs(want).max() > 10.0
    for c in range(2):
        np.testing.assert_array_equal(got[c].numpy().view(np.int32), want[c].view(np.int32))
    # another order of the same samples gives other bits somewhere
    perm = np.random.default_rng(seed).permutation(pts.shape[2])
    shuffled = sequential_scatter(pts[:, :, perm], val[:, :, perm], normals[:, :, perm], h, w)
    assert not np.array_equal(shuffled.view(np.int32), want.view(np.int32))


# ---- K3 / K4 -----------------------------------------------------------------------

def ae_inputs(labels, seed=1):
    """The AE terms' inputs from both packages: (port tensors, jax arrays)."""
    import jax.numpy as jnp
    import instance_segmentation_tpu.losses.ae_pallas as aep
    import instance_segmentation_tpu.losses.rasterize_pallas as rp
    from instance_segmentation_tpu.losses import losses as jl
    got_t, want_t = both_targets(labels)
    planes = np.random.default_rng(seed).normal(0, 1, (4, B, H, W)).astype(np.float32)
    xym_t = tl.coordinate_grid(H, W)
    xym_j = jl.coordinate_grid(H, W)
    np.testing.assert_array_equal(xym_t.numpy(), np.asarray(xym_j))
    ey, ex = (np.tanh(planes[i]) + np.asarray(xym_j[..., i]) for i in range(2))
    sy, sx = np.exp(planes[2]), np.exp(planes[3])
    fields = [f.astype(np.float32) for f in (ey, ex, sy, sx)]
    cnt, r2, _ = rp.rasterize_cnt_r2(want_t.points, want_t.pt_valid, H, W)
    # the JAX table, as _ae_instance_focal_dense builds it
    centers_int = want_t.centers.astype(jnp.int32)
    c_emb = xym_j[jnp.clip(centers_int[..., 0], 0, H - 1), jnp.clip(centers_int[..., 1], 0, W - 1)]
    kps, val = want_t.points, want_t.pt_valid
    kmin = jnp.min(jnp.where(val[..., None], kps, 1 << 20), axis=2)
    kmax = jnp.max(jnp.where(val[..., None], kps, -(1 << 20)), axis=2)
    ms = (kmax - kmin) * 2
    lt = jnp.clip(centers_int - ms // 2, 0, 2048)
    rb = centers_int + ms // 2
    rb = jnp.stack([jnp.clip(rb[..., 0], 0, H), jnp.clip(rb[..., 1], 0, W)], -1)
    tab_j = aep._pack_table(c_emb, lt, rb, want_t.inst_valid)
    anyp, cntp_j = aep._any_points_from_points(kps, val, H, W)
    jax_in = ([jnp.asarray(f) for f in fields], r2, cnt, tab_j, anyp, cntp_j)
    port_in = port_ae_inputs(got_t, fields)
    np.testing.assert_array_equal(port_in[1].numpy(), np.asarray(r2))
    np.testing.assert_array_equal(port_in[2].numpy(), np.asarray(cnt))
    np.testing.assert_array_equal(port_in[3].numpy()[..., :7],
                                  np.transpose(np.asarray(tab_j)[:, :7, :M], (0, 2, 1)))
    return port_in, jax_in


def port_ae_inputs(targets, fields):
    """(fields needing grad, r2, cnt, table, lut, tile presence) from the port."""
    cnt, r2, _ = trz.rasterize_cnt_r2(targets.points, targets.pt_valid, H, W)
    return ([torch.from_numpy(f).requires_grad_() for f in fields], r2, cnt,
            tl.ae_table(targets, tl.coordinate_grid(H, W), H, W), tae.neg4_lut(tl._NEG4_TABLE),
            tae.tile_presence(targets.points, targets.pt_valid, H, W))


def hold_ae_terms_to_pallas(port_in, jax_in):
    """The port's (pos, neg, npos, pull) to rtol 1e-5 of the reference's, and
    the gradient of a weighted sum of pos, neg and pull within 1e-4 of its
    max|g|; returns the port's terms."""
    import jax
    import jax.numpy as jnp
    import instance_segmentation_tpu.losses.ae_pallas as aep
    from instance_segmentation_tpu.losses import losses as jl
    fields_j, r2, cnt, tab_j, anyp, cntp_j = jax_in
    fields_t, *rest = port_in
    got = tae.ae_terms(*fields_t, *rest)
    table = tuple(sorted(jl._NEG4_TABLE.items()))

    def terms(*f):
        return aep.ae_terms(*f, r2, cnt, table, tab_j, anyp, cntp_j)
    want = terms(*fields_j)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **VALUE_TOL)
    # K4: the gradient of a weighted sum of pos, neg and pull
    wts = np.random.default_rng(2).normal(0, 1, (3, B, M)).astype(np.float32)

    def objective_j(*f):
        pos, neg, _, pull = terms(*f)
        return jnp.sum(wts[0] * pos + wts[1] * neg + wts[2] * pull)
    grads_j = jax.grad(objective_j, argnums=(0, 1, 2, 3))(*fields_j)
    pos, neg, _, pull = got
    wt = torch.from_numpy(wts)
    grads_t = torch.autograd.grad((wt[0] * pos + wt[1] * neg + wt[2] * pull).sum(), fields_t)
    for g, w in zip(grads_t, grads_j):
        assert _rel(g.numpy(), np.asarray(w)) <= GRAD_TOL
    return got


@pytest.mark.parametrize("labels", list(LABELS))
def test_ae_terms_and_gradient_match_pallas(labels, interpret):
    hold_ae_terms_to_pallas(*ae_inputs(labels))


NOT_VALID = ((0, 1), (1, 3))    # (image, instance) with samples but no valid flag


def test_ae_terms_sum_the_pull_of_instances_without_a_valid_flag(interpret):
    """Instances whose valid flag is 0 but which have samples (input the loss
    never builds): no focal terms, their pull summed and differentiated with
    dmax over the valid centers, as in the reference. Their windows are
    emptied too, since the reference's focal window ignores the flag."""
    port_in, jax_in = ae_inputs("octagons")
    tab, tab_j = port_in[3].clone(), jax_in[3]
    for b, m in NOT_VALID:
        assert bool(port_in[2][b, m].view(torch.int16).ne(0).any())
        assert float(tab[b, m, tae.VALID]) > 0
        tab[b, m, tae.LT0:tae.VALID + 1] = 0.0
        tab_j = tab_j.at[b, tae.LT0:tae.VALID + 1, m].set(0.0)
    got = hold_ae_terms_to_pallas((*port_in[:3], tab, *port_in[4:]),
                                  (*jax_in[:3], tab_j, *jax_in[4:]))
    for b, m in NOT_VALID:
        assert [float(x[b, m].detach()) for x in got[:3]] == [0.0, 0.0, 0.0]
        assert float(got[3][b, m].detach()) > 0.0


def test_tile_presence_marks_every_sample_tile():
    pts, val, h, w = scattered_points(h=64, w=256)
    cntp = tae.tile_presence(torch.from_numpy(pts), torch.from_numpy(val), h, w)
    cnt = trz.sample_count(torch.from_numpy(pts), torch.from_numpy(val), h, w)
    nh, nw = tae.num_tiles(h, w)
    assert cntp.dtype == torch.int32 and tuple(cntp.shape) == (2, nh * nw, 4)
    dense = cnt.view(2, 6, nh, tae.TILE_H, nw, tae.TILE_W).sum((3, 5)) > 0
    np.testing.assert_array_equal(tae.presence_dense(cntp, 6).numpy(),
                                  dense.reshape(2, 6, -1).numpy())


@pytest.mark.parametrize("m", [32, 100, 128])
def test_tile_presence_bits_are_the_dense_pairs(m):
    """The bitmask marks exactly the (tile, instance) pairs a dense reference
    marks, every bit position of the 4 words included (bit 31 makes a word
    negative), and the twin's results do not depend on it."""
    rng = np.random.default_rng(m)
    b, p, h, w = 2, 48, 48, 192
    pts = np.stack([rng.integers(-10, h + 10, (b, m, p)), rng.integers(-10, w + 10, (b, m, p))],
                   axis=-1).astype(np.int32)
    val = rng.uniform(size=(b, m, p)) < 0.3
    val[0, ::7] = False
    pts_t, val_t = torch.from_numpy(pts), torch.from_numpy(val)
    cntp = tae.tile_presence(pts_t, val_t, h, w)
    nh, nw = tae.num_tiles(h, w)
    want = np.zeros((b, m, nh * nw), bool)
    for i, j, k in zip(*np.nonzero(val)):
        y, x = min(max(pts[i, j, k, 0], 0), h - 1), min(max(pts[i, j, k, 1], 0), w - 1)
        want[i, j, (y // tae.TILE_H) * nw + x // tae.TILE_W] = True
    words = cntp.numpy().view(np.uint32)
    got = (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    got = got.reshape(b, nh * nw, -1)[..., :m].transpose(0, 2, 1).astype(bool)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tae.presence_dense(cntp, m).numpy(), want)
    assert (cntp < 0).any() == want[:, 31::32].any()
    # the twin reads no presence: a full and an empty mask give the same terms
    fields = [torch.from_numpy(rng.normal(0, 1, (b, h, w)).astype(np.float32)) for _ in range(4)]
    fields[2], fields[3] = fields[2].exp(), fields[3].exp()
    cnt, r2, _ = trz.rasterize_cnt_r2(pts_t, val_t, h, w)
    tab = tae.pack_table(torch.rand(b, m, 2), torch.zeros(b, m, 2),
                         torch.full((b, m, 2), 40.0), torch.from_numpy(val.any(axis=2)))
    lut = tae.neg4_lut(tl._NEG4_TABLE)
    terms = [tae.ae_terms(*fields, r2, cnt, tab, lut, c)
             for c in (cntp, torch.full_like(cntp, -1), torch.zeros_like(cntp))]
    for other in terms[1:]:
        assert all(torch.equal(a, c) for a, c in zip(terms[0], other))


def test_tile_presence_refuses_more_instances_than_its_words_hold():
    pts = torch.zeros((1, tae.MAX_M + 1, 4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most"):
        tae.tile_presence(pts, torch.ones(pts.shape[:3], dtype=torch.bool), 16, 64)


# ---- the losses ----------------------------------------------------------------------

def _jax_heads(planes, reg, cls):
    import jax.numpy as jnp
    kp = jnp.asarray(planes[0])
    return (kp, tuple(jnp.asarray(p) for p in planes[1:5]),
            tuple(jnp.asarray(p) for p in planes[5:7]), jnp.asarray(reg), jnp.asarray(cls))


def _port_heads(planes, reg, cls):
    t = [torch.from_numpy(p).requires_grad_() for p in planes]
    return (t[0], tuple(t[1:5]), tuple(t[5:7]), torch.from_numpy(reg).requires_grad_(),
            torch.from_numpy(cls).requires_grad_()), t


@pytest.mark.parametrize("labels", list(LABELS))
def test_compose_loss_and_head_gradients_match_jax(labels, interpret):
    """The six stats to rtol 1e-5, and the gradient with respect to every
    head output within 1e-4 of its max|g|."""
    import jax
    import jax.numpy as jnp
    from instance_segmentation_tpu.losses import losses as jl
    got_t, want_t = both_targets(labels)
    planes, reg, cls, anchors = head_outputs(seed=5)
    cfg = jl.LossConfig(ae_impl="pallas")

    def loss_j(planes_, reg_, cls_):
        return jl.compose_loss(_jax_heads(planes_, reg_, cls_), want_t, jnp.asarray(anchors), cfg)
    (_, want), grads_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(planes), jnp.asarray(reg), jnp.asarray(cls))

    outputs, leaves = _port_heads(planes, reg, cls)
    total, got = tl.compose_loss(outputs, got_t, torch.tensor(anchors))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), err_msg=k,
                                   **VALUE_TOL)
    total.backward()
    g_planes = np.stack([t.grad.numpy() for t in leaves])
    for g, w in ((g_planes, grads_j[0]), (outputs[3].grad.numpy(), grads_j[1]),
                 (outputs[4].grad.numpy(), grads_j[2])):
        assert _rel(g, np.asarray(w)) <= GRAD_TOL


@torch.no_grad()
def test_each_loss_matches_jax(interpret):
    import jax.numpy as jnp
    from instance_segmentation_tpu.losses import losses as jl
    got_t, want_t = both_targets("octagons")
    planes, reg, cls, anchors = head_outputs(seed=6)
    heads_j = _jax_heads(planes, reg, cls)
    heads_t, _ = _port_heads(planes, reg, cls)
    anchors_t = torch.tensor(anchors)
    for g, w in zip(tl.det_focal_loss(heads_t[4], heads_t[3], anchors_t, got_t.det_ann),
                    jl.det_focal_loss(heads_j[4], heads_j[3], jnp.asarray(anchors),
                                      want_t.det_ann)):
        np.testing.assert_allclose(g.item(), float(w), **VALUE_TOL)
    cnt, r2, uni = trz.rasterize_cnt_r2(got_t.points, got_t.pt_valid, H, W)
    np.testing.assert_allclose(float(tl.kp_focal_loss_from_union(heads_t[0], uni)),
                               float(jl.kp_focal_loss_from_union(heads_j[0],
                                                                 jnp.asarray(uni.numpy()))),
                               **VALUE_TOL)
    xym = tl.coordinate_grid(H, W)
    np.testing.assert_allclose(
        float(tl.ae_loss(heads_t[1], got_t, xym, cnt, r2)),
        float(jl.ae_loss(heads_j[1], want_t, jl.coordinate_grid(H, W),
                         jl.LossConfig(ae_impl="pallas"), jnp.asarray(cnt.numpy()),
                         jnp.asarray(r2.numpy()))), **VALUE_TOL)
    np.testing.assert_allclose(float(tl.tangent_loss(heads_t[2], got_t)),
                               float(jl.tangent_loss(heads_j[2], want_t,
                                                     jl.LossConfig(ae_impl="pallas"))),
                               **VALUE_TOL)


def test_constants_match_jax():
    from instance_segmentation_tpu.losses import losses as jl
    assert tl._NEG4_TABLE == jl._NEG4_TABLE
    assert trz.R2_BIG == jl._R2_BIG
    lut = tae.neg4_lut(tl._NEG4_TABLE)
    assert float(lut[200]) == 1.0 and float(lut[0]) == tl._NEG4_TABLE[0]
    j, t = jl.LossConfig(), tl.LossConfig()
    for k in ("alpha", "gamma", "pos_iou", "neg_iou", "reg_weight", "ae_weight", "tan_weight"):
        assert getattr(j, k) == getattr(t, k), k


# ---- the wrappers --------------------------------------------------------------------

def test_cpu_wrappers_run_the_twins_without_launching():
    pts, val, h, w = scattered_points()
    pts_t, val_t = torch.from_numpy(pts), torch.from_numpy(val)
    before = dict(trz.launches), dict(tae.launches)
    cnt, r2, uni = trz.rasterize_cnt_r2(pts_t, val_t, h, w)
    want = trz.rasterize_cnt_r2_plain(pts_t, val_t, h, w)
    assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for a, b in zip((cnt, r2, uni), want))
    trz.rasterize_nmap(pts_t, val_t, torch.zeros(pts.shape, dtype=torch.float32), h, w)
    assert (trz.launches, tae.launches) == before


def test_wrappers_reject_other_devices_and_bad_inputs():
    pts, val, h, w = scattered_points()
    pts_t, val_t = torch.from_numpy(pts), torch.from_numpy(val)
    with pytest.raises(ValueError, match="cuda or cpu"):
        trz.rasterize_cnt_r2(pts_t.to("meta"), val_t.to("meta"), h, w)
    with pytest.raises(ValueError, match="points"):
        trz.rasterize_cnt_r2(pts_t.long(), val_t, h, w)
    with pytest.raises(ValueError, match="pt_valid"):
        trz.rasterize_nmap(pts_t, val_t.int(), torch.zeros(pts.shape), h, w)
    with pytest.raises(ValueError, match="multiple of 4"):
        trz.rasterize_cnt_r2(pts_t, val_t, h, 126)
    targets = tt.generate_targets(*map(torch.from_numpy, octagon_labels()), H, W, max_points=P,
                                  dense_kp=False)
    fields = [np.ones((B, H, W), np.float32)] * 4
    fields, r2, cnt, tab, lut, cntp = port_ae_inputs(targets, fields)
    with pytest.raises(ValueError, match="cnt"):
        tae.ae_terms(*fields, r2, cnt.view(torch.int16), tab, lut, cntp)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tae.ae_terms(*(f.detach().to("meta") for f in fields),
                     *(t.to("meta") for t in (r2, cnt, tab, lut, cntp)))


def test_kernel_sources_name_what_they_replace():
    from instance_segmentation_torch.kernels import build
    for name, fns, replaced in (("rasterize", ("iseg_rasterize_cnt_r2", "iseg_rasterize_nmap",
                                               "iseg_minr2_from_cnt"),
                                 ("rasterize_pallas.py", "minr2_pallas.py")),
                                ("ae_terms", ("iseg_ae_terms_fwd", "iseg_ae_terms_bwd"),
                                 ("ae_pallas.py",))):
        src = (build.CSRC / f"{name}.cu").read_text()
        assert all(r in src for r in replaced) and all(f'extern "C" int {f}(' in src for f in fns)
        assert build.library_path(name).name.startswith(f"{name}-")
    src = (build.CSRC / "ae_terms.cu").read_text()
    assert f"kTileH = {tae.TILE_H};" in src and f"kTileW = {tae.TILE_W};" in src
    assert f"kMaxM = {tae.MAX_M};" in src
    assert f"kTabW = {tae.pack_table(*[torch.zeros(1, 1, 2)] * 3, torch.zeros(1, 1)).shape[-1]};" in src
    # K3's scratch is sized by the kernel's own entry point (ctypes c_longlong)
    assert 'extern "C" long long iseg_ae_partial_floats(int B, int M, int H, int W) {' in src
    from instance_segmentation_torch.kernels import minr2
    src = (build.CSRC / "rasterize.cu").read_text()
    assert f"kBandH = {minr2.BAND_H};" in src and f"kBandW = {minr2.BAND_W};" in src
    assert f"kFillBytes = {minr2.FILL_BYTES};" in src


# ---- on a card -----------------------------------------------------------------------

def _card_points(dev, seed=0):
    """Octagon samples plus one border-clipped instance and an empty image,
    from the port's own target generation."""
    polys, n_verts, cls_ids = octagon_labels(seed)
    border = border_clipped_labels()[0]
    polys[1, 5], n_verts[1, 5], cls_ids[1, 5] = border[0, 0], 4, 3
    t = tt.generate_targets(*(torch.from_numpy(a).to(dev) for a in (polys, n_verts, cls_ids)),
                            H, W, max_points=P, dense_kp=False)
    return t


@pytest.mark.cuda
def test_rasterizers_match_twins_on_card(cuda_device):
    t = _card_points(cuda_device)
    before = dict(trz.launches)
    got = trz.rasterize_cnt_r2(t.points, t.pt_valid, H, W)
    want = trz.rasterize_cnt_r2_plain(t.points, t.pt_valid, H, W)
    n = trz.rasterize_nmap(t.points, t.pt_valid, t.normals, H, W)
    n_plain = trz.rasterize_nmap_plain(t.points, t.pt_valid, t.normals, H, W)
    torch.cuda.synchronize()
    assert trz.launches["rasterize_cnt_r2"] == before["rasterize_cnt_r2"] + 1
    assert trz.launches["rasterize_nmap"] == before["rasterize_nmap"] + 1
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
    for g, w in zip(n, n_plain):
        assert torch.allclose(g, w, rtol=1e-5, atol=1e-5)
    # bitwise: against the twin on the CPU and across two launches
    n_cpu = trz.rasterize_nmap_plain(t.points.cpu(), t.pt_valid.cpu(), t.normals.cpu(), H, W)
    again = trz.rasterize_nmap(t.points, t.pt_valid, t.normals, H, W)
    for g, w, a in zip(n, n_cpu, again):
        assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))
    pts, val, normals, h, w = piled_points(0, w=128)
    piled = [torch.from_numpy(a) for a in (pts, val, normals)]
    got = trz.rasterize_nmap(*(a.to(cuda_device) for a in piled), h, w)
    for g, w_ in zip(got, trz.rasterize_nmap_plain(*piled, h, w)):
        assert torch.equal(g.cpu().view(torch.int32), w_.view(torch.int32))


def _hold_ae_terms_to_twin_on_card(cuda_device, not_valid=()):
    """K3 to rtol 1e-5 of the twin and bitwise equal across two launches, K4
    through the autograd.Function within 1e-4 of max|g| of the twin's
    autograd, on the card points with the (image, instance) pairs
    ``not_valid`` keeping their samples but losing their valid flag. Returns
    K3's terms."""
    t = _card_points(cuda_device)
    cnt, r2, _ = trz.rasterize_cnt_r2(t.points, t.pt_valid, H, W)
    xym = tl.coordinate_grid(H, W, cuda_device)
    planes = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (4, B, H, W)).astype(np.float32)).to(cuda_device)
    fields = [torch.tanh(planes[0]) + xym[..., 0], torch.tanh(planes[1]) + xym[..., 1],
              torch.exp(planes[2]), torch.exp(planes[3])]
    fields = [f.contiguous().requires_grad_() for f in fields]
    tab = tl.ae_table(t, xym, H, W)
    for b, m in not_valid:
        tab[b, m, tae.VALID] = 0.0
    rest = (r2, cnt, tab, tae.neg4_lut(tl._NEG4_TABLE, cuda_device),
            tae.tile_presence(t.points, t.pt_valid, H, W))
    wts = torch.randn((3, B, M), generator=torch.Generator().manual_seed(0)).to(cuda_device)
    results = []
    for fn in (tae.ae_terms, tae.ae_terms_plain):
        pos, neg, npos, pull = fn(*fields, *rest)
        grads = torch.autograd.grad((wts[0] * pos + wts[1] * neg + wts[2] * pull).sum(), fields)
        results.append(((pos, neg, npos, pull), grads))
    torch.cuda.synchronize()
    (got, g_got), (want, g_want) = results
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=1e-5, atol=0.0)
    # K3 sums without float atomics: two launches agree in every bit
    again = tae.ae_terms_fwd(*(f.detach() for f in fields), *rest)
    for g, a in zip(got, again):
        assert torch.equal(g.detach().view(torch.int32), a.view(torch.int32))
    for g, w in zip(g_got, g_want):
        assert float((g - w).abs().max()) <= GRAD_TOL * float(w.abs().max())
    return got


@pytest.mark.cuda
def test_ae_terms_match_twin_on_card(cuda_device):
    _hold_ae_terms_to_twin_on_card(cuda_device)
    # the scratch of K3: a float4 partial per (image, instance, tile)
    _, partial_floats, _, _ = tae._kernels()
    nh, nw = tae.num_tiles(H, W)
    assert partial_floats(B, M, H, W) == B * M * nh * nw * 4


@pytest.mark.cuda
def test_ae_terms_sum_the_pull_of_instances_without_a_valid_flag_on_card(cuda_device):
    """As on the CPU, with the windows kept: the kernels and the twin both
    take the window only of a valid instance; among the tiles holding the
    samples of such an instance, some hold no other instance's."""
    t = _card_points(cuda_device)
    presence = tae.presence_dense(tae.tile_presence(t.points, t.pt_valid, H, W), M)
    for b, m in NOT_VALID:
        alone = presence[b, m] & ~presence[b, torch.arange(M, device=cuda_device) != m].any(0)
        assert bool(alone.any()), (b, m)
    got = _hold_ae_terms_to_twin_on_card(cuda_device, NOT_VALID)
    for b, m in NOT_VALID:
        assert [float(x[b, m].detach()) for x in got[:3]] == [0.0, 0.0, 0.0]
        assert float(got[3][b, m].detach()) > 0.0


def _bits(x):
    return x.view(torch.int32).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["train cell", "full resolution"])
def test_loss_kernels_match_twins_at_the_cells_shapes_on_card(cuda_device, where):
    """B=8, M=96, P=1024, 512x1024 (the labels with a border-clipped
    instance and an image without labels; (cnt, r2) from K2, bitwise equal to
    its twin) and B=1, 1024x2048 ((cnt, r2) from the count map and K6): K5
    to rtol 1e-5 of the twin on the card and bitwise equal to the twin on
    the CPU and across two launches; K3 to rtol 1e-5 and bitwise equal across
    two launches; K4 within 1e-4 of max|g| of the twin's autograd on the
    first and last images, and equal to it through the autograd.Function."""
    dev = cuda_device
    if where == "train cell":
        b, m, p, h, w = TRAIN_SHAPE
        labels = bench_train_batch(b, m, h, w, edge_cases=True)[1]
    else:
        b, m, p, h, w = FULLRES_SHAPE
        labels = fullres_batch(b, m, h, w)[1]
    t = tt.generate_targets(*(torch.from_numpy(a).to(dev) for a in labels), h, w, max_points=p,
                            dense_kp=False)
    if where == "train cell":
        cnt, r2, union = trz.rasterize_cnt_r2(t.points, t.pt_valid, h, w)
        for g, x in zip((cnt, r2, union), trz.rasterize_cnt_r2_plain(t.points, t.pt_valid, h, w)):
            assert g.dtype == x.dtype and g.shape == x.shape
            assert torch.equal(g.view(torch.uint8), x.view(torch.uint8))
    else:
        cnt = tl.ae_sample_count(t, h, w)
        r2 = tm2.minr2_from_cnt(cnt, t.pt_valid.any(dim=2))

    # K5
    nk = trz.rasterize_nmap(t.points, t.pt_valid, t.normals, h, w)
    again = trz.rasterize_nmap(t.points, t.pt_valid, t.normals, h, w)
    twin = trz.rasterize_nmap_plain(t.points, t.pt_valid, t.normals, h, w)
    cpu = trz.rasterize_nmap_plain(t.points.cpu(), t.pt_valid.cpu(), t.normals.cpu(), h, w)
    for a, c, c_cpu, a2 in zip(nk, twin, cpu, again):
        assert torch.allclose(a, c, rtol=1e-5, atol=1e-5)
        assert torch.equal(_bits(a), _bits(c_cpu)) and torch.equal(_bits(a), _bits(a2))

    # K3
    xym = tl.coordinate_grid(h, w, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    planes = torch.randn((4, b, h, w), generator=gen, device=dev)
    fields = [(torch.tanh(planes[0]) + xym[..., 0]).contiguous(),
              (torch.tanh(planes[1]) + xym[..., 1]).contiguous(),
              torch.exp(planes[2]), torch.exp(planes[3])]
    tab = tl.ae_table(t, xym, h, w)
    rest = (r2, cnt, tab, tae.neg4_lut(tl._NEG4_TABLE, dev),
            tae.tile_presence(t.points, t.pt_valid, h, w))
    k3 = tae.ae_terms_fwd(*fields, *rest)
    again = tae.ae_terms_fwd(*fields, *rest)
    with torch.no_grad():
        p3 = tae.ae_terms_plain(*fields, *rest)
    for a, c, a2 in zip(k3, p3, again):
        assert torch.allclose(a, c, rtol=1e-5, atol=0.0)
        assert torch.equal(_bits(a), _bits(a2))

    # K4 on the first and last images against the twin's autograd there
    sub = torch.tensor(sorted({0, b - 1}), device=dev)
    fields2 = [f[sub].contiguous().requires_grad_() for f in fields]
    rest2 = (r2[sub].contiguous(), cnt.view(torch.int16)[sub].view(torch.uint16),
             tab[sub].contiguous(), rest[3], rest[4][sub].contiguous())
    wts = torch.randn((3, b, m), generator=gen, device=dev)[:, sub]
    k4 = tae.ae_terms_bwd(*(f.detach() for f in fields2), *rest2, *wts)
    pos, neg, _, pull = tae.ae_terms_plain(*fields2, *rest2)
    p4 = torch.autograd.grad((wts[0] * pos + wts[1] * neg + wts[2] * pull).sum(), fields2)
    pos, neg, _, pull = tae.ae_terms(*fields2, *rest2)
    f4 = torch.autograd.grad((wts[0] * pos + wts[1] * neg + wts[2] * pull).sum(), fields2)
    for a, c, f in zip(k4, p4, f4):
        assert float((a - c).abs().max()) <= GRAD_TOL * float(c.abs().max())
        assert torch.equal(a, f)
