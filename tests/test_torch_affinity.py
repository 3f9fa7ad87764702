"""Kernel K1 (instance_segmentation_torch/kernels/affinity.py): the plain
PyTorch version against the JAX Pallas kernel (interpret mode on the CPU)
and against the reference's dense XLA grouping; the wrapper's dispatch and
input checks; and, on a CUDA card only, the kernel against the plain
version (marked ``cuda``). JAX is imported inside the tests that use it, so
that the card test runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_affinity.py
"""

import numpy as np
import pytest
import torch

from instance_segmentation_torch.kernels import affinity, build

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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
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
