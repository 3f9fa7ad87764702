"""Kernel K1 (instance_segmentation_torch/kernels/affinity.py): the plain
PyTorch version against the JAX Pallas kernel (interpret mode on the CPU)
and against the reference's dense XLA grouping, on random, decode-ordered
and edge-case inputs (NaN, inf and underflow in the scores); a numpy model
of the kernel's culling and packed-key argmax against the XLA grouping; the
wrapper's dispatch and input checks; and, on a CUDA card only, the kernel
against the plain version (marked ``cuda``). JAX is imported inside the
tests that use it, so that the card tests run where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_affinity.py
"""

import numpy as np
import pytest
import torch

from instance_segmentation_torch.kernels import affinity, build

import torch_cases
from torch_cases import cuda_device  # noqa: F401 (a fixture)

EDGE_CASES = torch_cases.affinity_edge_cases()
EDGE_IDS = [name for name, _ in EDGE_CASES]

torch.set_num_threads(2)


def _inputs(b, k, d, seed):
    """Random keypoints/centers as in tests/test_pallas_kernels.py, batched."""
    rng = np.random.default_rng(seed)
    kp_rc = rng.uniform(0, 128, (b, k, 2)).astype(np.float32)
    emb = rng.normal(0.5, 0.2, (b, k, 2)).astype(np.float32)
    sig = np.exp(rng.normal(0, 0.5, (b, k, 2))).astype(np.float32)
    c_emb = rng.normal(0.5, 0.2, (b, d, 2)).astype(np.float32)
    xy = rng.uniform(0, 100, (b, d, 2)).astype(np.float32)
    wh = rng.uniform(10, 60, (b, d, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    det_valid = rng.uniform(size=(b, d)) > 0.2
    return kp_rc, emb, sig, c_emb, boxes, det_valid


def _xla_grouping(kp_rc, emb, sig, c_emb, boxes, det_valid):
    """The reference decode's dense grouping (ops/decode.py _decode_core)."""
    import jax.numpy as jnp
    contained = ((kp_rc[..., 0:1] >= boxes[..., None, :, 1]) &
                 (kp_rc[..., 0:1] <= boxes[..., None, :, 3]) &
                 (kp_rc[..., 1:2] >= boxes[..., None, :, 0]) &
                 (kp_rc[..., 1:2] <= boxes[..., None, :, 2]))
    contained = contained & det_valid[:, None, :]
    dists = jnp.exp(-jnp.sum(
        (emb[:, :, None, :] - c_emb[:, None, :, :]) ** 2 * sig[:, :, None, :], axis=-1))
    scored = dists * contained.astype(jnp.float32)
    return jnp.argmax(scored, axis=-1), jnp.max(scored, axis=-1)


def _plain(arrays):
    a, b = affinity.affinity_assign_plain(*(torch.from_numpy(x) for x in arrays))
    return a.numpy(), b.numpy()


def _assert_same_grouping(got, want):
    """best to rtol 1e-6; assign equal wherever the top score is nonzero
    (elsewhere both are slot 0, checked separately)."""
    (ga, gb), (wa, wb) = got, want
    np.testing.assert_allclose(gb, wb, rtol=1e-6)
    nonzero = wb > 0
    np.testing.assert_array_equal(ga[nonzero], wa[nonzero])


def test_plain_matches_xla_grouping():
    import jax
    import jax.numpy as jnp
    arrays = _inputs(3, 2000, 40, seed=0)
    got = _plain(arrays)
    want = jax.jit(_xla_grouping)(*(jnp.asarray(x) for x in arrays))
    want = tuple(np.asarray(w) for w in want)
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32
    _assert_same_grouping(got, want)
    np.testing.assert_array_equal(got[0][want[1] == 0], 0)


def _xla(arrays, jit=False):
    """The XLA grouping of ``arrays``, op by op unless ``jit``. Under jit,
    XLA rewrites ``dists * contained`` into a select (an outside NaN scores
    0) and picks among several NaNs by its reduce order; op by op, the
    expression's own rules hold: NaN * 0 is NaN, the first NaN wins."""
    import jax
    import jax.numpy as jnp
    fn = jax.jit(_xla_grouping) if jit else _xla_grouping
    with np.errstate(all="ignore"):
        want = fn(*(jnp.asarray(x) for x in arrays))
    return tuple(np.asarray(w) for w in want)


def _assert_same_with_nan(got, want):
    """assign exactly equal; best to rtol 1e-6, NaN where the reference's
    is NaN."""
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=0.0, equal_nan=True)


@pytest.mark.parametrize("case", range(len(EDGE_CASES)), ids=EDGE_IDS)
def test_plain_matches_xla_grouping_on_edge_cases(case):
    """NaN, inf and underflow in the scores: the twin takes the first NaN
    (NaN * 0 being NaN) and slot 0 where every score is 0, as the grouping's
    expression does op by op (numpy's rules)."""
    arrays = EDGE_CASES[case][1]
    with np.errstate(all="ignore"):
        got = _plain(arrays)
        no_nan = ~np.isnan(affinity.affinity_scores_plain(
            *(torch.from_numpy(x) for x in arrays)).numpy()).any(-1)
    _assert_same_with_nan(got, _xla(arrays))
    # jitted, the grouping agrees wherever no score is NaN
    jitted = _xla(arrays, jit=True)
    _assert_same_with_nan((got[0][no_nan], got[1][no_nan]),
                          (jitted[0][no_nan], jitted[1][no_nan]))


def test_plain_matches_xla_grouping_in_decode_order():
    arrays = torch_cases.affinity_inputs(2, 3000, 96, seed=9, decode_order=True)
    flat = arrays[0][..., 0] * 1024 + arrays[0][..., 1]
    assert (np.diff(flat, axis=-1) > 0).all()
    got, want = _plain(arrays), _xla(arrays)
    _assert_same_grouping(got, want)
    np.testing.assert_array_equal(got[0][want[1] == 0], 0)


def test_against_cpu_twin_counts_what_the_card_tests_refuse():
    """``torch_cases.against_cpu_twin`` (the card tests' comparison) finds
    nothing wrong in the twin's own answer, and counts as bad an assignment
    moved from a clear winner (every other score equal to it or under half
    of it) to a center scoring 0, and a best off by 1e-5 as not within rtol
    1e-6."""
    inputs = [torch.from_numpy(x) for x in torch_cases.affinity_inputs(2, 3000, 96, seed=13)]
    a, b = affinity.affinity_assign_plain(*inputs)
    cmp = torch_cases.against_cpu_twin(a, b, inputs)
    assert cmp["bad"] == 0 and cmp["best_ok"] and cmp["mismatch"] == 0
    assert cmp["exact_ties"] > 0 and cmp["in_no_box"] > 0
    scored = affinity.affinity_scores_plain(*inputs).flatten(0, 1)
    top = scored.amax(-1, keepdim=True)
    clear = ((top[:, 0] > 0) & ((scored == top) | (scored < 0.5 * top)).all(-1)
             & (scored == 0).any(-1))
    clear = int(clear.nonzero()[0])
    moved = a.clone().flatten()
    moved[clear] = int((scored[clear] == 0).nonzero()[0])
    cmp = torch_cases.against_cpu_twin(moved.view_as(a), b, inputs)
    assert cmp["bad"] == 1 and cmp["best_ok"]
    off = b.clone().flatten()
    off[clear] *= 1 + 1e-5
    assert not torch_cases.against_cpu_twin(a, off.view_as(b), inputs)["best_ok"]


def _packed_key_argmax(scored):
    """The kernel's first-max argmax, numpy: the max over d of (score bits
    << 32 | 0xffffffff - d), NaN as 0x7fc00000, started at (0, d = 0)."""
    bits = np.where(np.isnan(scored), np.uint32(0x7fc00000), scored.view(np.uint32))
    d = np.arange(scored.shape[-1], dtype=np.uint64)
    keys = (bits.astype(np.uint64) << np.uint64(32)) | (np.uint64(0xffffffff) - d)
    top = np.maximum(keys.max(axis=-1), np.uint64(0xffffffff))
    assign = (np.uint64(0xffffffff) - (top & np.uint64(0xffffffff))).astype(np.int32)
    best = (top >> np.uint64(32)).astype(np.uint32).view(np.float32)
    return assign, best


def test_packed_key_argmax_matches_jnp_argmax():
    """Rows of scores >= 0 or NaN, with +inf, exact ties, all zeros and
    several NaNs: the packed key gives jnp.argmax and jnp.max."""
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    scored = rng.choice(np.array([0.0, 0.25, 0.5, 1.0, np.inf, np.nan], np.float32),
                        size=(400, 7), p=[0.4, 0.15, 0.15, 0.1, 0.1, 0.1])
    scored[:20] = 0.0
    scored[20:40] = rng.uniform(0, 1, (20, 7)).astype(np.float32)
    assign, best = _packed_key_argmax(scored)
    np.testing.assert_array_equal(assign, np.asarray(jnp.argmax(jnp.asarray(scored), axis=-1)))
    np.testing.assert_array_equal(best, np.asarray(jnp.max(jnp.asarray(scored), axis=-1)))
    assert (assign[:20] == 0).all() and np.isnan(best).any()


def _kernel_model(kp_rc, emb, sig, c_emb, boxes, det_valid, warp=32):
    """The kernel's culling, numpy: an odd keypoint (emb not finite, or sig
    not in (0, inf)) scored against every center; each other keypoint
    against the centers of its ``warp`` whose box meets the warp's
    bounding rectangle (its odd keypoints left out) and the centers whose
    c_emb is not finite, only where it lies in the box or the center is such
    a one; the argmax by the packed key."""
    B, K = kp_rc.shape[:2]
    assign = np.zeros((B, K), np.int32)
    best = np.zeros((B, K), np.float32)
    for b in range(B):
        y1 = np.where(det_valid[b], boxes[b, :, 1], np.float32(np.nan))
        x1, y2, x2 = boxes[b, :, 0], boxes[b, :, 3], boxes[b, :, 2]
        odd_center = ~np.isfinite(c_emb[b]).all(-1)
        for w0 in range(0, K, warp):
            rc, e, s = (a[b, w0:w0 + warp] for a in (kp_rc, emb, sig))
            odd = ~(np.isfinite(e).all(-1) & (s > 0).all(-1) & (s < np.inf).all(-1))
            placed = ~np.isnan(rc).any(-1) & ~odd
            rmin, rmax = rc[placed, 0].min(initial=np.inf), rc[placed, 0].max(initial=-np.inf)
            cmin, cmax = rc[placed, 1].min(initial=np.inf), rc[placed, 1].max(initial=-np.inf)
            kept = (y1 <= rmax) & (y2 >= rmin) & (x1 <= cmax) & (x2 >= cmin) | odd_center
            inside = ((rc[:, 0:1] >= y1) & (rc[:, 0:1] <= y2) &
                      (rc[:, 1:2] >= x1) & (rc[:, 1:2] <= x2))
            dy, dx = e[:, 0:1] - c_emb[b, :, 0], e[:, 1:2] - c_emb[b, :, 1]
            score = np.exp(-(dy * dy * s[:, 0:1] + dx * dx * s[:, 1:2])) * inside
            scored = odd[:, None] | kept & (odd_center | inside)
            a, t = _packed_key_argmax(np.where(scored, score, np.float32(0)))
            assign[b, w0:w0 + warp], best[b, w0:w0 + warp] = a, t
    return assign, best


@pytest.mark.parametrize("case", range(len(EDGE_CASES) + 2),
                         ids=EDGE_IDS + ["random order", "decode order"])
def test_kernel_model_matches_xla_grouping(case):
    """Culling skips only pairs that score 0: the model of the kernel's
    culling gives the XLA grouping op by op, NaN cases included."""
    if case < len(EDGE_CASES):
        arrays = EDGE_CASES[case][1]
    else:
        arrays = torch_cases.affinity_inputs(2, 2000, 96, seed=10,
                                            decode_order=case > len(EDGE_CASES))
    with np.errstate(all="ignore"):
        _assert_same_with_nan(_kernel_model(*arrays), _xla(arrays))


def test_plain_matches_pallas_kernel_interpret():
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from instance_segmentation_tpu.ops import pallas_kernels as pk
    arrays = _inputs(2, 3000, 24, seed=1)
    got = _plain(arrays)
    for b in range(2):
        with pltpu.force_tpu_interpret_mode():
            want = pk.affinity_assign(*(jnp.asarray(x[b]) for x in arrays))
        _assert_same_grouping((got[0][b], got[1][b]), tuple(np.asarray(w) for w in want))


def _edge_case_inputs():
    """Keypoint 0 in no box; keypoint 1 in box 2 only, whose detection is
    invalid; keypoint 2 in boxes 1 and 3, which are identical (exact tie);
    keypoint 3 in boxes 1, 3 and 0, box 0 the closest center."""
    kp_rc = np.array([[[5, 5], [50, 90], [30, 30], [12, 12]]], np.float32)
    emb = np.array([[[0.3, 0.3], [0.5, 0.5], [0.4, 0.4], [0.1, 0.1]]], np.float32)
    sig = np.full((1, 4, 2), 2.0, np.float32)
    boxes = np.array([[[10, 10, 20, 20], [10, 10, 60, 60],      # x1, y1, x2, y2
                       [80, 40, 100, 60], [10, 10, 60, 60]]], np.float32)
    c_emb = np.array([[[0.1, 0.1], [0.35, 0.35], [0.5, 0.5], [0.35, 0.35]]], np.float32)
    det_valid = np.array([[True, True, False, True]])
    return kp_rc, emb, sig, c_emb, boxes, det_valid


def test_slot_zero_and_first_max_rules():
    arrays = _edge_case_inputs()
    assign, best = _plain(arrays)
    assert assign[0].tolist() == [0, 0, 1, 0]
    assert best[0, 0] == 0.0 and best[0, 1] == 0.0
    assert best[0, 2] > 0.0 and best[0, 3] > 0.0
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from instance_segmentation_tpu.ops import pallas_kernels as pk
    jax_in = [jnp.asarray(x) for x in arrays]
    xla = jax.jit(_xla_grouping)(*jax_in)
    with pltpu.force_tpu_interpret_mode():
        pallas = pk.affinity_assign(*(x[0] for x in jax_in))
    for ref_assign, ref_best in (xla, (pallas[0][None], pallas[1][None])):
        np.testing.assert_array_equal(np.asarray(ref_assign), assign)
        np.testing.assert_allclose(np.asarray(ref_best), best, rtol=1e-6)


def test_wrapper_runs_plain_on_cpu_without_launching():
    arrays = [torch.from_numpy(x) for x in _inputs(2, 300, 16, seed=2)]
    before = affinity.launches
    a, b = affinity.affinity_assign(*arrays)
    pa, pb = affinity.affinity_assign_plain(*arrays)
    assert affinity.launches == before
    assert torch.equal(a, pa) and torch.equal(b, pb)


def test_wrapper_rejects_other_devices_and_bad_inputs():
    arrays = [torch.from_numpy(x) for x in _inputs(1, 64, 8, seed=3)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        affinity.affinity_assign(*(t.to("meta") for t in arrays))
    bad = list(arrays)
    bad[1] = bad[1].double()
    with pytest.raises(ValueError, match="emb"):
        affinity.affinity_assign(*bad)
    bad = list(arrays)
    bad[5] = bad[5].int()
    with pytest.raises(ValueError, match="det_valid"):
        affinity.affinity_assign(*bad)
    bad = list(arrays)
    bad[2] = bad[2].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        affinity.affinity_assign(*bad)
    big = [torch.from_numpy(x) for x in _inputs(1, 8, affinity.MAX_CENTERS + 1, seed=4)]
    with pytest.raises(ValueError, match="centers"):
        affinity.affinity_assign(*big)


def test_build_is_keyed_on_the_source():
    path = build.library_path("affinity")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("affinity-") and path.suffix == ".so"
    assert build.BUILD_DIR.parent.parent == build.CSRC.parent.parent
    assert "compute_90a,code=sm_90a" in " ".join(build.NVCC_FLAGS)
    assert "--use_fast_math" not in build.NVCC_FLAGS
    src = (build.CSRC / "affinity.cu").read_text()
    assert "pallas_kernels.py" in src and "iseg_affinity_assign" in src


def test_ptxas_usage_reads_the_build_log(tmp_path, monkeypatch):
    """One line per kernel from nvcc's -Xptxas -v output kept beside the
    library; the kernel's name is cut out of its mangled name."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    entry = "_ZN68_GLOBAL__N__2b6f7a6d_12_rasterize_cu_0b1c2d3411nmap_kernelEPKiS1_"
    build.library_path("rasterize").with_suffix(".log").write_text(
        "ptxas info    : 0 bytes gmem\n"
        f"ptxas info    : Compiling entry function '{entry}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {entry}\n"
        "    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 80 registers, used 1 barriers, 6160 bytes smem, 448 bytes cmem[0]\n")
    assert build.ptxas_usage("rasterize") == [
        "nmap_kernel: 80 registers, 12 bytes spill stores, 8 bytes spill loads, 6160 bytes smem"]
    assert build.ptxas_usage("ae_terms") == []
    assert "-Xptxas" in build.NVCC_FLAGS


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    arrays = [torch.from_numpy(x).to(cuda_device) for x in _inputs(4, 5000, 96, seed=5)]
    before = affinity.launches
    a, b = affinity.affinity_assign(*arrays)
    pa, pb = affinity.affinity_assign_plain(*arrays)
    torch.cuda.synchronize()
    assert affinity.launches == before + 1
    assert torch.allclose(b, pb, rtol=1e-6, atol=0.0)
    nonzero = pb > 0
    assert torch.equal(a[nonzero], pa[nonzero])
    assert bool((a[~nonzero] == 0).all())
    edge = [torch.from_numpy(x).to(cuda_device) for x in _edge_case_inputs()]
    assert affinity.affinity_assign(*edge)[0].cpu().tolist() == [[0, 0, 1, 0]]
    shifted = list(arrays)                # the keypoint pairs are read 8 bytes at a time
    shifted[0] = torch.empty(arrays[0].numel() + 1, device=cuda_device)[1:].view_as(arrays[0])
    with pytest.raises(ValueError, match="8-byte aligned"):
        affinity.affinity_assign(*shifted)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(EDGE_CASES)), ids=EDGE_IDS)
def test_kernel_matches_cpu_twin_on_edge_cases_on_card(cuda_device, case):
    """NaN, inf and underflow in the scores, D = 1 and 1024, K not a multiple
    of the block, no box near the keypoints: the kernel against the twin
    computed on the CPU (assign equal, best to rtol 1e-6 and NaN where the
    twin's is)."""
    arrays = EDGE_CASES[case][1]
    inputs = [torch.from_numpy(x).to(cuda_device) for x in arrays]
    a, b = affinity.affinity_assign(*inputs)
    torch.cuda.synchronize()
    with np.errstate(all="ignore"):
        want = _plain(arrays)
    _assert_same_with_nan((a.cpu().numpy(), b.cpu().numpy()), want)


@pytest.mark.cuda
def test_kernel_matches_plain_in_decode_order_on_card(cuda_device):
    arrays = torch_cases.affinity_inputs(8, 20000, 96, seed=12, decode_order=True)
    inputs = [torch.from_numpy(x).to(cuda_device) for x in arrays]
    a, b = affinity.affinity_assign(*inputs)
    cmp = torch_cases.against_cpu_twin(a, b, inputs)
    assert cmp["bad"] == 0 and cmp["best_ok"], cmp


@pytest.mark.cuda
def test_kernel_matches_cpu_twin_in_random_order_at_the_decode_shape_on_card(cuda_device):
    """B=8, K=20000, D=96, keypoints in random order (no culling by rows
    helps): assign equal outside near ties, best to rtol 1e-6."""
    arrays = torch_cases.affinity_inputs(*torch_cases.AFFINITY_SHAPE)
    inputs = [torch.from_numpy(x).to(cuda_device) for x in arrays]
    before = affinity.launches
    a, b = affinity.affinity_assign(*inputs)
    cmp = torch_cases.against_cpu_twin(a, b, inputs)
    assert affinity.launches == before + 1
    assert cmp["bad"] == 0 and cmp["best_ok"], cmp
    assert cmp["in_no_box"] > 0 and cmp["exact_ties"] > 0, cmp
