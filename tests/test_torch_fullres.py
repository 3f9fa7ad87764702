"""The port's full-resolution training slice against the JAX package, at small
shapes (EfficientSeg-B0, 128x512, B=2, M=8), float32, on the CPU:

* the count-map route of ``compose_loss`` (P=60: the rasterizer's rule
  refuses P % 8 != 0, so both packages build the count map with a
  scatter-add, then the min-r2 map with K6 and run K3/K4; the reference's
  Pallas kernels in interpret mode), its loss alone and in a whole step;
* activation checkpointing (``EfficientSegConfig.remat``) against none, with
  drop-connect on;
* the windowed AE loss (``LossConfig(ae_window=...)``), the gaussian window
  target and the kp loss from the point list;
* the entry point ``tools/fullres_demo.py``: its synthetic batch and flags.
"""

import argparse

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instance_segmentation_torch.kernels import minr2 as tm2
from instance_segmentation_torch.kernels import rasterize as trz
from instance_segmentation_torch.losses import losses as tl
from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig
from instance_segmentation_torch.ops import targets as tt
from instance_segmentation_torch.tools import fullres_demo
from instance_segmentation_torch.training.synthetic import fullres_batch
from instance_segmentation_torch.training.train_step import Trainer
from instance_segmentation_torch.weights import load_flax_variables, port_tensors_from_flax

from test_torch_losses import (
    GRAD_TOL, VALUE_TOL, _jax_heads, _port_heads, _rel, border_clipped_labels, head_outputs,
    octagon_labels,
)
from test_torch_model import random_flax_variables

torch.set_num_threads(2)
B, H, W, M = 2, 128, 512, 8
P_COUNT = 60                         # P % 8 != 0: the count-map route in both packages
STEP_STAT_TOL = dict(rtol=1e-4, atol=0.0)     # as test_torch_train.py
STEP_GRAD_TOL = 1e-3
WINDOW = (64, 128)
LABELS = {"octagons": octagon_labels, "border_clipped": border_clipped_labels}


@pytest.fixture
def interpret():
    """The JAX package's Pallas kernels in interpret mode on the CPU."""
    import instance_segmentation_tpu.losses.ae_pallas as aep
    import instance_segmentation_tpu.losses.minr2_pallas as m2p
    import instance_segmentation_tpu.losses.rasterize_pallas as rp
    old = (aep.INTERPRET, m2p.INTERPRET, rp.INTERPRET)
    aep.INTERPRET = m2p.INTERPRET = rp.INTERPRET = True
    yield
    aep.INTERPRET, m2p.INTERPRET, rp.INTERPRET = old


def both_targets(labels, p):
    from instance_segmentation_tpu.ops.targets import generate_targets
    arrays = LABELS[labels]()
    want = jax.jit(lambda a, n, c: generate_targets(a, n, c, H, W, max_points=p,
                                                    dense_kp=False))(*map(jnp.asarray, arrays))
    got = tt.generate_targets(*map(torch.from_numpy, arrays), H, W, max_points=p,
                              dense_kp=False)
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    np.testing.assert_array_equal(got.pt_valid.numpy(), np.asarray(want.pt_valid))
    return got, want


@pytest.fixture
def routes(monkeypatch):
    """Counts the route functions each package calls; the port's K2 (kernel
    and twin) raises if called."""
    import instance_segmentation_tpu.losses.minr2_pallas as m2p
    import instance_segmentation_tpu.losses.rasterize_pallas as rp
    calls = {"jax_minr2": 0, "jax_k2": 0, "port_minr2": 0}

    def counted(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    def refuse(*args, **kwargs):
        raise AssertionError("the port took the rasterizer K2")
    monkeypatch.setattr(m2p, "minr2_from_cnt", counted("jax_minr2", m2p.minr2_from_cnt))
    monkeypatch.setattr(rp, "rasterize_cnt_r2", counted("jax_k2", rp.rasterize_cnt_r2))
    monkeypatch.setattr(tm2, "minr2_from_cnt", counted("port_minr2", tm2.minr2_from_cnt))
    monkeypatch.setattr(trz, "rasterize_cnt_r2", refuse)
    monkeypatch.setattr(trz, "rasterize_cnt_r2_plain", refuse)
    return calls


def _loss_and_head_grads(labels, p, jax_cfg, port_cfg):
    """(JAX stats, JAX head gradients, port stats, port head gradients) of
    compose_loss on seeded random heads."""
    from instance_segmentation_tpu.losses import losses as jl
    got_t, want_t = both_targets(labels, p)
    planes, reg, cls, anchors = head_outputs(seed=5)

    def loss_j(planes_, reg_, cls_):
        return jl.compose_loss(_jax_heads(planes_, reg_, cls_), want_t, jnp.asarray(anchors),
                               jax_cfg)
    (_, want), grads_j = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(planes), jnp.asarray(reg), jnp.asarray(cls))
    outputs, leaves = _port_heads(planes, reg, cls)
    total, got = tl.compose_loss(outputs, got_t, torch.tensor(anchors), port_cfg)
    total.backward()
    grads_t = (np.stack([t.grad.numpy() for t in leaves]), outputs[3].grad.numpy(),
               outputs[4].grad.numpy())
    return want, grads_j, got, grads_t


def _assert_loss_match(want, grads_j, got, grads_t):
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), err_msg=k,
                                   **VALUE_TOL)
    for g, w in zip(grads_t, grads_j):
        assert _rel(g, np.asarray(w)) <= GRAD_TOL


# ---- the count-map route ----------------------------------------------------------------

@pytest.mark.parametrize("labels", list(LABELS))
def test_count_route_compose_loss_matches_jax(labels, interpret, routes):
    """At P=60 both packages take the count-map route: the stats to rtol
    1e-5, the head gradients within 1e-4 of their max|g|."""
    import instance_segmentation_tpu.losses.rasterize_pallas as rp
    from instance_segmentation_tpu.losses import losses as jl
    assert not tl.rasterizer_supported(H, W, P_COUNT) and not rp.supported(H, W, P_COUNT)
    assert tl.rasterizer_supported(H, W, 64) == rp.supported(H, W, 64)
    _assert_loss_match(*_loss_and_head_grads(labels, P_COUNT, jl.LossConfig(ae_impl="pallas"),
                                             tl.LossConfig()))
    assert routes == {"jax_minr2": 1, "jax_k2": 0, "port_minr2": 1}


@pytest.mark.parametrize("hwp", [(128, 512, 64), (128, 512, 60), (512, 1024, 1024),
                                 (1024, 2048, 1024), (256, 768, 64), (64, 384, 32)])
def test_route_rule_is_the_reference_rule(hwp):
    import instance_segmentation_tpu.losses.rasterize_pallas as rp
    assert tl.rasterizer_supported(*hwp) == rp.supported(*hwp)


def test_count_route_pieces_match_jax():
    """ae_sample_count and the kp loss from the count map, bitwise and to
    rtol 1e-5."""
    from instance_segmentation_tpu.losses import losses as jl
    got_t, want_t = both_targets("octagons", P_COUNT)
    cnt = tl.ae_sample_count(got_t, H, W)
    cnt_j = jl.ae_sample_count(want_t, H, W)
    assert cnt.dtype == torch.uint16
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    kp = np.random.default_rng(9).normal(0, 1, (B, H, W)).astype(np.float32)
    np.testing.assert_allclose(float(tl.kp_focal_loss_from_cnt(torch.from_numpy(kp), cnt)),
                               float(jl.kp_focal_loss_from_cnt(jnp.asarray(kp), cnt_j)),
                               **VALUE_TOL)


@pytest.fixture(scope="module")
def count_step():
    """One whole step at P=60: the loss function of ``make_train_step``
    (reference kernels in interpret mode, drop-connect patched to the
    identity) and a port Trainer's compute_grads on the same weights."""
    import instance_segmentation_tpu.losses.ae_pallas as aep
    import instance_segmentation_tpu.losses.minr2_pallas as m2p
    import instance_segmentation_tpu.losses.rasterize_pallas as rp
    import instance_segmentation_tpu.models.efficientnet as jeff
    from instance_segmentation_tpu.losses import LossConfig, compose_loss
    from instance_segmentation_tpu.models import EfficientSeg as JaxSeg
    from instance_segmentation_tpu.models import EfficientSegConfig as JaxCfg
    from instance_segmentation_tpu.models import generate_anchors
    from instance_segmentation_tpu.ops.targets import generate_targets

    model = JaxSeg(JaxCfg(num_classes=8, compound_coef=0, backbone_s2d=False, unet_s2d=False))
    frames = np.random.default_rng(30).integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    variables = random_flax_variables(model, jnp.asarray(frames), train=False, seed=31)
    labels = octagon_labels(seed=32)
    anchors = jnp.asarray(generate_anchors(H, W, pyramid_levels=model.cfg.pyramid_levels,
                                           anchor_scale=model.cfg.anchor_scale))

    def loss_fn(params, batch_stats, images, polys, n_verts, cls_ids):
        targets = generate_targets(polys, n_verts, cls_ids, H, W, max_points=P_COUNT,
                                   dense_kp=False)
        outputs, mutated = model.apply({"params": params, "batch_stats": batch_stats},
                                       images, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                                       mutable=["batch_stats"])
        total, stats = compose_loss(outputs, targets, anchors, LossConfig(ae_impl="pallas"))
        return total, (stats, mutated["batch_stats"])

    saved = (aep.INTERPRET, m2p.INTERPRET, rp.INTERPRET, jeff.drop_connect)
    aep.INTERPRET = m2p.INTERPRET = rp.INTERPRET = True
    jeff.drop_connect = lambda x, rate, deterministic, rng: x
    try:
        (_, (stats, new_bs)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"], jnp.asarray(frames),
            *map(jnp.asarray, labels))
    finally:
        aep.INTERPRET, m2p.INTERPRET, rp.INTERPRET, jeff.drop_connect = saved
    trainer = Trainer(EfficientSegConfig(num_classes=8, compound_coef=0, drop_connect_rate=0.0),
                      variables, (H, W), max_points=P_COUNT, device=torch.device("cpu"))
    before = tm2.launches["minr2_from_cnt"], dict(trz.launches)
    got = trainer.compute_grads(frames, *labels)
    assert (tm2.launches["minr2_from_cnt"], trz.launches) == before     # CPU: twins only
    return {"stats": stats, "grads": grads, "batch_stats": new_bs, "trainer": trainer,
            "got": got}


def test_count_route_step_matches_jax(count_step):
    """The six stats to rtol 1e-4; every gradient leaf within 1e-3 of the
    step's max|g| and the whole gradient within 1e-3 in relative L2 (the
    tolerances of test_torch_train.py, which says why); the new batch
    statistics to rtol 1e-5."""
    got, want = count_step["got"], count_step["stats"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **STEP_STAT_TOL)
    model = count_step["trainer"].model
    grads = port_tensors_from_flax(model, {"params": count_step["grads"]})
    params = dict(model.named_parameters())
    assert sorted(grads) == sorted(params)
    top = max(float(w.abs().max()) for w in grads.values())
    sq_err = sq_ref = 0.0
    for key, w in grads.items():
        g = params[key].grad
        assert float((g - w).abs().max()) <= STEP_GRAD_TOL * top, key
        sq_err += float(((g - w) ** 2).sum())
        sq_ref += float((w ** 2).sum())
    assert sq_err ** 0.5 <= STEP_GRAD_TOL * sq_ref ** 0.5
    bs = port_tensors_from_flax(model, {"batch_stats": count_step["batch_stats"]})
    buffers = dict(model.named_buffers())
    for key, w in bs.items():
        np.testing.assert_allclose(buffers[key].numpy(), w.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=key)


# ---- activation checkpointing -------------------------------------------------------------

def test_remat_computes_what_no_remat_computes():
    """With drop-connect at rate 0.2 from a seeded generator: the stats and
    the running statistics bitwise equal, the gradients within 1e-6 of
    max|g|, the generator left in the same state; and the backbone did run
    twice (forward and recompute) with remat."""
    frames = np.random.default_rng(40).integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    labels = octagon_labels(seed=41)
    results = []
    for remat in (False, True):
        cfg = EfficientSegConfig(num_classes=8, compound_coef=0, drop_connect_rate=0.2,
                                 remat=remat)
        trainer = Trainer(cfg, torch.Generator().manual_seed(0), (H, W), max_points=64,
                          device=torch.device("cpu"), drop_seed=7)
        backbone = trainer.model.backbone_net["model"]
        initial = backbone.generator.get_state()
        runs = []
        backbone.register_forward_pre_hook(lambda *_: runs.append(1))
        stats = trainer.compute_grads(frames, *labels)
        results.append({
            "stats": stats, "runs": len(runs), "gen": backbone.generator.get_state(),
            "initial": initial,
            "buffers": {k: b.clone() for k, b in trainer.model.named_buffers()},
            "grads": {k: p.grad.clone() for k, p in trainer.model.named_parameters()}})
    plain, remat = results
    assert (plain["runs"], remat["runs"]) == (1, 2)
    assert not torch.equal(plain["gen"], plain["initial"])         # masks were drawn
    assert torch.equal(plain["gen"], remat["gen"])
    for k in plain["stats"]:
        assert torch.equal(plain["stats"][k], remat["stats"][k]), k
    for k in plain["buffers"]:
        assert torch.equal(plain["buffers"][k], remat["buffers"][k]), k
    top = max(float(g.abs().max()) for g in plain["grads"].values())
    for k, g in plain["grads"].items():
        assert float((remat["grads"][k] - g).abs().max()) <= 1e-6 * top, k


def test_remat_model_loads_the_jax_remat_tree():
    from instance_segmentation_tpu.models import EfficientSeg as JaxSeg
    from instance_segmentation_tpu.models import EfficientSegConfig as JaxCfg
    model = JaxSeg(JaxCfg(num_classes=8, compound_coef=0, remat=True, backbone_s2d=False,
                          unet_s2d=False))
    variables = random_flax_variables(model, jnp.zeros((1, 128, 256, 3), jnp.uint8), train=False)
    port = EfficientSeg(EfficientSegConfig(num_classes=8, compound_coef=0, remat=True))
    assert load_flax_variables(port, variables) == len(port.state_dict())


# ---- the windowed AE loss ---------------------------------------------------------------

@pytest.mark.parametrize("labels", list(LABELS))
def test_windowed_compose_loss_matches_jax(labels, interpret, monkeypatch):
    """ae_window=(64, 128): the stats to rtol 1e-5 and the head gradients
    within 1e-4 of their max|g|; no rasterizer and no K6 run in the port."""
    from instance_segmentation_tpu.losses import losses as jl

    def refuse(*args, **kwargs):
        raise AssertionError("the windowed route ran a count-map kernel")
    for module, name in ((trz, "rasterize_cnt_r2"), (trz, "sample_count"),
                         (tm2, "minr2_from_cnt")):
        monkeypatch.setattr(module, name, refuse)
    _assert_loss_match(*_loss_and_head_grads(labels, 64, jl.LossConfig(ae_window=WINDOW),
                                             tl.LossConfig(ae_window=WINDOW)))


def test_gaussian_window_target_matches_jax():
    """A border-clipped instance: samples outside the window, on its edges
    and repeated."""
    from instance_segmentation_tpu.ops.targets import gaussian_window_target
    rng = np.random.default_rng(50)
    pts = np.stack([rng.integers(-20, 80, 64), rng.integers(-30, 150, 64)], -1).astype(np.int32)
    pts[:4] = [[0, 0], [63, 127], [0, 127], [63, 0]]
    pts[4] = pts[5]
    val = rng.uniform(size=64) > 0.3
    val[:6] = True
    inside = (pts[:, 0] >= 0) & (pts[:, 0] < 64) & (pts[:, 1] >= 0) & (pts[:, 1] < 128)
    val_in = val & inside
    want = np.asarray(gaussian_window_target(jnp.asarray(pts), jnp.asarray(val_in), *WINDOW))
    got = tt.gaussian_window_target(torch.from_numpy(pts), torch.from_numpy(val_in), *WINDOW)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0.0)
    batched = tt.gaussian_window_target(torch.from_numpy(np.stack([pts, pts[::-1]]))[None],
                                        torch.from_numpy(np.stack([val_in, val_in[::-1]]))[None],
                                        *WINDOW)
    assert torch.equal(batched[0, 0], got) and torch.equal(batched[0, 1], got)


def test_kp_focal_loss_from_points_matches_jax():
    from instance_segmentation_tpu.losses import losses as jl
    got_t, want_t = both_targets("octagons", 64)
    kp = np.random.default_rng(51).normal(0, 1, (B, H, W)).astype(np.float32)
    kp_t = torch.from_numpy(kp).requires_grad_()
    loss = tl.kp_focal_loss_from_points(kp_t, got_t)
    want, grad_j = jax.value_and_grad(jl.kp_focal_loss_from_points)(jnp.asarray(kp), want_t)
    np.testing.assert_allclose(float(loss.detach()), float(want), **VALUE_TOL)
    loss.backward()
    assert _rel(kp_t.grad.numpy(), np.asarray(grad_j)) <= GRAD_TOL
    # the same value as the union map's loss (the points' union is the target)
    _, _, uni = trz.rasterize_cnt_r2_plain(got_t.points, got_t.pt_valid, H, W)
    np.testing.assert_allclose(float(loss.detach()),
                               float(tl.kp_focal_loss_from_union(kp_t.detach(), uni)), rtol=1e-5)


# ---- the entry point --------------------------------------------------------------------

def _demo_loop(b, m, h, w, n_real=16):
    """The batch loop of the JAX package's tools/fullres_demo.py, copied."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (b, h, w, 3), dtype=np.uint8)
    polys = np.zeros((b, m, 8, 2), np.float32)
    n_verts = np.zeros((b, m), np.int32)
    cls_ids = np.full((b, m), -1, np.int32)
    for bi in range(b):
        for mi in range(n_real):
            cy, cx = rng.uniform(160, h - 160), rng.uniform(240, w - 240)
            rh, rw = rng.uniform(40, 140), rng.uniform(60, 200)
            ang = np.linspace(0, 2 * np.pi, 9)[:-1]
            polys[bi, mi] = np.stack([cy + rh * np.sin(ang), cx + rw * np.cos(ang)], -1)
            n_verts[bi, mi] = 8
            cls_ids[bi, mi] = rng.integers(0, 8)
        polys[bi, n_real:] = polys[bi, 0, 0]
    return images, (polys, n_verts, cls_ids)


def test_fullres_batch_is_the_demo_batch():
    frames, labels = fullres_batch(2, 24, 384, 640)
    want_frames, want_labels = _demo_loop(2, 24, 384, 640)
    np.testing.assert_array_equal(frames, want_frames)
    for g, w in zip(labels, want_labels):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_fullres_demo_takes_the_reference_flags():
    args = fullres_demo.parse_args(
        ["--batch", "4", "--compound", "3", "--hw", "1024", "2048", "--iters", "3",
         "--max-instances", "96", "--max-points", "1024", "--n-real", "16", "--remat",
         "--ae-window", "256", "512"])
    assert (args.batch, args.compound, list(args.hw), args.iters) == (4, 3, [1024, 2048], 3)
    assert (args.max_instances, args.max_points, args.n_real) == (96, 1024, 16)
    assert args.remat and list(args.ae_window) == [256, 512] and args.device is None
    default = fullres_demo.parse_args([])
    assert (default.batch, list(default.hw), default.remat, default.ae_window) == (
        1, [1024, 2048], False, None)
    assert isinstance(default, argparse.Namespace)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            fullres_demo.run(default)


def test_fullres_demo_runs_on_the_cpu_at_a_small_size():
    """B0 at 384x512 with P=60 (the count-map route), remat on, 1 timed step."""
    out = fullres_demo.run(fullres_demo.parse_args(
        ["--compound", "0", "--hw", "384", "512", "--iters", "1", "--max-instances", "20",
         "--max-points", "60", "--remat", "--device", "cpu"]))
    assert out["hw"] == [384, 512] and out["remat"] and out["device"] == "cpu"
    assert np.isfinite(out["total_loss"]) and out["step_ms"] > 0
    assert out["peak_hbm_gb"] is None
