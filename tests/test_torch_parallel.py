"""The port's data parallelism on the CPU: two ranks over gloo, spawned once
for the module (a rendezvous file in a temporary directory, no port), each
given its half of a global batch of 4 (EfficientSeg-B0, 128x512, M=8,
float32, drop-connect 0):

* the sync ``BatchNorm`` on two half batches against one ``BatchNorm`` on
  the whole batch and against flax's: output, running statistics and input
  gradient;
* the 2-rank step (``Trainer(group=...)``: DDP, sync batch norm, the global
  kp normaliser) against the port's 1-rank step on the whole batch, at P=64
  (the rasterizer's route), P=60 (the count map) and P=64 with remat, to
  the bounds of ``tools/multichip.py`` (which says why the whole gradient is
  held to 2e-2, each element to 1e-2 of max|g| and each loss term's head to
  1e-4); and against the JAX
  single-device step (Pallas kernels in interpret mode) as
  ``tests/test_torch_train.py`` holds the 1-rank step;
* the same check with the batch-norm sums or the kp sums left per rank,
  which must miss its bounds by 10x or more;
* a checkpoint saved by rank 0 and restored on both ranks, device
  augmentation drawn for the global batch, and the batch split.

Besides: ``multihost.spawn`` stopping every rank when one fails or hangs,
and the full-width path of ``tools/multichip.py`` on one CPU rank.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from instance_segmentation_torch.losses import losses as tlosses
from instance_segmentation_torch.models import EfficientSegConfig
from instance_segmentation_torch.models import layers as tl
from instance_segmentation_torch.parallel import multihost
from instance_segmentation_torch.tools import multichip
from instance_segmentation_torch.training.synthetic import small_train_batch
from instance_segmentation_torch.training.train_step import Trainer

torch.set_num_threads(2)
WORLD = 2
B, (H, W), M = multichip.CHECK_BATCH, multichip.CHECK_HW, multichip.CHECK_M
CASES = {"p64": {"p": 64, "remat": False}, "p60": {"p": 60, "remat": False},
         "p64_remat": {"p": 64, "remat": True}}
BN_KINDS = {"det": (tl.BN_EPS_DET, tl.BN_MOMENTUM_DET),
            "unet": (tl.BN_EPS_UNET, tl.BN_MOMENTUM_UNET)}
BN_TOL = dict(rtol=1e-5, atol=1e-6)
STAT_TOL = dict(rtol=1e-4, atol=0.0)            # against JAX, as test_torch_train.py
GRAD_TOL = 1e-3


def _bn_case(kind):
    """x [4, 9, 11, 6] NHWC, a cotangent, scale/bias and running stats."""
    rng = np.random.default_rng({"det": 0, "unet": 1}[kind])
    c = 6
    x = rng.normal(0.7, 1.3, (B, 9, 11, c)).astype(np.float32)
    ct = rng.normal(0.0, 1.0, x.shape).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.normal(0, 0.2, c).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.2, c).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    return x, ct, params, stats


def _bn_train(kind, x, ct, group=None):
    """The port's BatchNorm in training on NHWC ``x`` with ``group``: its
    output, new running statistics and the gradient of sum(y * ct) by x."""
    eps, momentum = BN_KINDS[kind]
    _, _, params, stats = _bn_case(kind)
    bn = tl.BatchNorm(x.shape[-1], eps=eps, momentum=momentum)
    with torch.no_grad():
        for name, v in (("weight", params["scale"]), ("bias", params["bias"]),
                        ("running_mean", stats["mean"]), ("running_var", stats["var"])):
            getattr(bn, name).copy_(torch.from_numpy(v))
    assert tl.set_batchnorm_group(bn, group) == 1
    xt = torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).requires_grad_()
    y = bn.train()(xt)
    (y * torch.from_numpy(np.ascontiguousarray(ct)).permute(0, 3, 1, 2)).sum().backward()
    return {"y": y.detach().permute(0, 2, 3, 1).numpy(), "mean": bn.running_mean.numpy(),
            "var": bn.running_var.numpy(), "dx": xt.grad.permute(0, 2, 3, 1).numpy()}


def _kp_local(cls_l, reg_l, kp_sums, ae_l, tan_l, group):
    """What a plain DDP wrap computes: each rank's kp focal loss over its own
    normaliser, and its own stats."""
    kp_l = tlosses.kp_focal_from_sums(*kp_sums)
    total = cls_l + reg_l + kp_l + ae_l + tan_l
    stats = {"cls_loss": cls_l, "wh_loss": reg_l, "kp_loss": kp_l, "ae_loss": ae_l,
             "tan_loss": tan_l, "total_loss": total}
    return total, {k: v.detach() for k, v in stats.items()}


def _aug_batch(group):
    cfg = EfficientSegConfig(num_classes=8, compound_coef=0, drop_connect_rate=0.0)
    trainer = Trainer(cfg, torch.Generator().manual_seed(0), (H, W), max_points=64,
                      device=torch.device("cpu"), group=group, device_aug=True, aug_seed=5)
    frames, labels = small_train_batch(B, M, H, W, seed=3)
    images, polys, _, _ = trainer._as_batch(frames, *labels)
    return images, polys


def _rank(rank, world, init_method, variables, out_dir):
    torch.set_num_threads(2)
    device = multihost.maybe_initialize("cpu", init_method=init_method, rank=rank,
                                        world_size=world)
    group = dist.group.WORLD
    per = B // world
    half = slice(rank * per, (rank + 1) * per)
    try:
        out = {"slice": multihost.process_batch_slice(B, group)}
        with pytest.raises(ValueError, match="not divisible") as err:
            multihost.process_batch_slice(B + 1, group)
        out["uneven"] = str(err.value)
        out["bn"] = {}
        for kind in BN_KINDS:
            x, ct, _, _ = _bn_case(kind)
            out["bn"][kind] = _bn_train(kind, x[half], ct[half], group)
        out["cases"] = multichip.check(group, device, variables, list(CASES.values()),
                                       keep=True)
        for r in out["cases"][1:]:
            del r["record"]                  # the JAX comparison reads P=64's
        frames, labels = multichip.check_batch()
        want = multichip.step_record(multichip.check_trainer(variables, 64, False, None, device),
                                     frames, labels)
        trainer = multichip.check_trainer(variables, 64, False, group, device)
        tl.set_batchnorm_group(trainer.model, None)
        out["bn_local"] = multichip.compare(multichip.step_record(trainer, frames, labels), want,
                                            group)
        saved = tlosses._data_parallel
        tlosses._data_parallel = _kp_local
        try:
            out["kp_local"] = multichip.check(group, device, variables, [CASES["p64"]])[0]
        finally:
            tlosses._data_parallel = saved
        out["resume"] = multichip.check_resume(group, device, os.path.join(out_dir, "ckpt"),
                                               variables)
        out["aug"] = _aug_batch(group)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _plain(tree):
    return {k: _plain(v) for k, v in tree.items()} if hasattr(tree, "items") \
        else np.asarray(tree)


@pytest.fixture(scope="module")
def jax_case():
    """The JAX model and seeded variables (B0, standard layout)."""
    import jax.numpy as jnp
    from instance_segmentation_tpu.models import EfficientSeg as JaxSeg
    from instance_segmentation_tpu.models import EfficientSegConfig as JaxCfg
    from test_torch_model import random_flax_variables
    model = JaxSeg(JaxCfg(num_classes=8, compound_coef=0, backbone_s2d=False, unet_s2d=False))
    variables = random_flax_variables(model, jnp.zeros((1, H, W, 3), jnp.uint8), train=False,
                                      seed=21)
    return model, _plain(variables)


@pytest.fixture(scope="module")
def ranks(jax_case, tmp_path_factory):
    """Both ranks' results (one spawn for the module)."""
    out = tmp_path_factory.mktemp("ranks")
    multihost.spawn(_rank, WORLD, (f"file://{out}/rendezvous", jax_case[1], str(out)),
                    timeout=600)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.mark.parametrize("kind", list(BN_KINDS))
def test_sync_batchnorm_matches_one_batchnorm_and_flax(ranks, kind):
    import jax
    import jax.numpy as jnp
    from instance_segmentation_tpu.models import layers as jl
    x, ct, params, stats = _bn_case(kind)
    eps, momentum = BN_KINDS[kind]
    whole = _bn_train(kind, x, ct)
    jm = jl.BatchNorm(momentum=momentum, epsilon=eps)

    def apply(xj):
        return jm.apply({"params": {"BatchNorm_0": params},
                         "batch_stats": {"BatchNorm_0": stats}}, xj, train=True,
                        mutable=["batch_stats"])
    y_j, mutated = apply(jnp.asarray(x))
    dx_j = jax.grad(lambda xj: jnp.sum(apply(xj)[0] * ct))(jnp.asarray(x))
    new = mutated["batch_stats"]["BatchNorm_0"]
    halves = [r["bn"][kind] for r in ranks]
    for key, want in (("y", np.asarray(y_j)), ("dx", np.asarray(dx_j))):
        got = np.concatenate([h[key] for h in halves])
        np.testing.assert_allclose(got, whole[key], err_msg=key, **BN_TOL)
        np.testing.assert_allclose(got, want, err_msg=key, **BN_TOL)
    for key, flax_key in (("mean", "mean"), ("var", "var")):
        np.testing.assert_array_equal(halves[0][key], halves[1][key])     # every rank alike
        np.testing.assert_allclose(halves[0][key], whole[key], err_msg=key, **BN_TOL)
        np.testing.assert_allclose(halves[0][key], np.asarray(new[flax_key]), err_msg=key,
                                   **BN_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_one_rank(ranks, case):
    """Stats to rtol 1e-5; the gradient of each loss term's head to rel-L2
    1e-4, every element to 1e-2 of max|g| and the whole gradient to 2e-2,
    bounds above the float32 floor the check reports; the running statistics to rtol
    1e-5 and bitwise equal on both ranks; both ranks report the same."""
    got = [next(r for r in rank["cases"] if {k: r[k] for k in CASES[case]} == CASES[case])
           for rank in ranks]
    for r in got:
        assert r["stat_rel"] <= multichip.STAT_RTOL, r
        assert r["head_rel_l2"] <= multichip.HEAD_REL_L2, r
        assert r["grad_leaf_rel"] <= multichip.GRAD_LEAF_TOL, r
        assert r["grad_rel_l2"] <= multichip.GRAD_REL_L2, r
        assert r["floor_leaf_rel"] < multichip.GRAD_LEAF_TOL, r
        assert r["floor_rel_l2"] < multichip.GRAD_REL_L2, r
        assert r["bn_close"] and r["bn_equal_across_ranks"], r
    assert got[0]["stats"] == got[1]["stats"]
    assert got[0]["grad_rel_l2"] == got[1]["grad_rel_l2"]        # DDP: one averaged gradient
    assert multichip.check_ok(ranks[0]["cases"], ranks[0]["resume"]) == []


def test_two_ranks_match_jax(ranks, jax_case):
    """Rank 0's P=64 step against the JAX single-device step on the global
    batch: the six stats to rtol 1e-4, every gradient leaf within 1e-3 of the
    step's max|g| and the new running statistics to rtol 1e-5 (the bounds of
    test_torch_train.py); each loss term's head within 1e-3 in relative L2,
    and the whole gradient within ``multichip.GRAD_REL_L2``. The port's own
    1-rank step is 2.2e-3 from JAX in relative L2 on this batch and 2.7e-4
    with its images reordered (a BiFPN max-pool near-tie flips; see
    ``tools/multichip.py``), so the 1e-3 of test_torch_train.py is not a
    bound on the whole gradient here."""
    import jax
    import jax.numpy as jnp
    import instance_segmentation_tpu.losses.ae_pallas as aep
    import instance_segmentation_tpu.losses.rasterize_pallas as rp
    import instance_segmentation_tpu.models.efficientnet as jeff
    from instance_segmentation_tpu.losses import LossConfig, compose_loss
    from instance_segmentation_tpu.models import generate_anchors
    from instance_segmentation_tpu.ops.targets import generate_targets
    from instance_segmentation_torch.models import EfficientSeg
    from instance_segmentation_torch.weights import port_tensors_from_flax

    model, variables = jax_case
    frames, labels = multichip.check_batch()
    anchors = jnp.asarray(generate_anchors(H, W, pyramid_levels=model.cfg.pyramid_levels,
                                           anchor_scale=model.cfg.anchor_scale))

    def loss_fn(params, batch_stats, images, polys, n_verts, cls_ids):
        targets = generate_targets(polys, n_verts, cls_ids, H, W, max_points=64,
                                   dense_kp=False)
        outputs, mutated = model.apply({"params": params, "batch_stats": batch_stats},
                                       images, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                                       mutable=["batch_stats"])
        total, stats = compose_loss(outputs, targets, anchors, LossConfig(ae_impl="pallas"))
        return total, (stats, mutated["batch_stats"])

    saved = (aep.INTERPRET, rp.INTERPRET, jeff.drop_connect)
    aep.INTERPRET = rp.INTERPRET = True
    jeff.drop_connect = lambda x, rate, deterministic, rng: x
    try:
        (_, (stats, new_bs)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"], jnp.asarray(frames),
            *map(jnp.asarray, labels))
    finally:
        aep.INTERPRET, rp.INTERPRET, jeff.drop_connect = saved
    record = ranks[0]["cases"][0]["record"]
    for k, v in stats.items():
        np.testing.assert_allclose(record["stats"][k], float(v), err_msg=k, **STAT_TOL)
    port = EfficientSeg(EfficientSegConfig(num_classes=8, compound_coef=0))
    want = port_tensors_from_flax(port, {"params": grads})
    assert sorted(want) == sorted(record["grads"])
    top = max(float(w.abs().max()) for w in want.values())
    for key, w in want.items():
        err = float((record["grads"][key] - w).abs().max())
        assert err <= GRAD_TOL * top, (key, err, top)
    for head in multichip.HEADS:
        keys = [k for k in want if k.startswith(head)]
        assert keys, head
        assert multichip.rel_l2({k: record["grads"][k] for k in keys},
                                {k: want[k] for k in keys}) <= GRAD_TOL, head
    assert multichip.rel_l2(record["grads"], want) <= multichip.GRAD_REL_L2
    bs = port_tensors_from_flax(port, {"batch_stats": new_bs})
    assert sorted(bs) == sorted(record["buffers"])
    for key, w in bs.items():
        np.testing.assert_allclose(record["buffers"][key].numpy(), w.numpy(), err_msg=key,
                                   **BN_TOL)


@pytest.mark.parametrize("left_local", ["bn", "kp"])
def test_check_is_not_vacuous(ranks, left_local):
    """With the batch-norm sums left per rank the whole gradient and its
    largest element miss their bounds by 10x or more; with the kp sums left
    per rank (a plain DDP wrap) the stats and the kp head's gradient miss
    theirs by 10x or more."""
    if left_local == "bn":
        r = ranks[0]["bn_local"]
        assert r["grad_rel_l2"] >= 10 * multichip.GRAD_REL_L2, r
        assert r["grad_leaf_rel"] >= 10 * multichip.GRAD_LEAF_TOL, r
        assert not r["bn_close"] and not r["bn_equal_across_ranks"], r
    else:
        r = ranks[0]["kp_local"]
        assert r["stat_rel"] >= 10 * multichip.STAT_RTOL, r
        assert r["head_rel_l2"] >= 10 * multichip.HEAD_REL_L2, r


def test_two_rank_resume(ranks):
    """Rank 0 saved, both ranks restored the same file, and the restored
    trainer's next step equals the one that went on."""
    for r in ranks:
        resume = r["resume"]
        assert resume["resume_rel"] == 0.0, resume
        assert (resume["start_epoch"], resume["best_ap"]) == (3, 0.25)
        assert resume["file"] == "efficient_weights_0002_0007.pth"
    assert ranks[0]["resume"]["stats"] == ranks[1]["resume"]["stats"]


def test_device_aug_draws_for_the_global_batch(ranks):
    """Each rank's augmented half is that half of the 1-rank augmented batch."""
    images, polys = _aug_batch(None)
    for rank, r in enumerate(ranks):
        half = slice(rank * B // WORLD, (rank + 1) * B // WORLD)
        assert torch.equal(r["aug"][0], images[half])
        assert torch.equal(r["aug"][1], polys[half])
    frames, labels = small_train_batch(B, M, H, W, seed=3)
    assert not torch.equal(images, torch.from_numpy(frames))         # something was drawn


def test_batch_slice_without_a_group():
    assert multihost.process_batch_slice(8) == (0, 8)           # no group: the whole batch


def test_batch_slice_on_two_ranks(ranks):
    assert [r["slice"] for r in ranks] == [(0, 2), (2, 2)]
    assert all("global batch 5 is not divisible by 2 ranks" in r["uneven"] for r in ranks)


def test_maybe_initialize_without_a_launcher(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.maybe_initialize("cpu") is None
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="rank and world_size"):
        multihost.maybe_initialize("cpu", init_method="file:///nonexistent/rendezvous")


def test_multichip_train_runs_on_the_cpu_at_a_small_size():
    """The full-width path of ``tools/multichip.py`` (one untimed step, then
    ``TRAIN_ITERS`` timed ones) on one CPU rank, with the check's B0 trainer
    and batch: finite stats, the kernels' plain versions only (no launch
    counted), one time a step."""
    trainer = multichip.check_trainer(0, 64, False, None, torch.device("cpu"))
    r = multichip.train(trainer, *multichip.check_batch())
    assert (r["rank"], r["world"], r["global_batch"], r["device"]) == (0, 1, B, "cpu")
    assert len(r["ms_per_step"]) == multichip.TRAIN_ITERS and r["peak_bytes"] is None
    assert all(np.isfinite(v) for v in r["stats"].values())
    assert set(r["launches"].values()) == {0}


def _fails_or_hangs(rank, world, fail_rank):
    if rank == fail_rank:
        raise ValueError(f"rank {rank} of {world} fails")
    time.sleep(600)


@pytest.mark.parametrize("fail_rank, timeout, match",
                         [(0, 300.0, "rank 0 of 2 fails"), (None, 5.0, "not done within 5")],
                         ids=["fails", "hangs"])
def test_spawn_stops_every_rank_when_one_fails_or_hangs(fail_rank, timeout, match):
    """A rank that raises, or ranks that outlive the timeout, make ``spawn``
    raise, after it has stopped the rank still sleeping (600 s)."""
    t0 = time.monotonic()
    with pytest.raises(Exception, match=match):
        multihost.spawn(_fails_or_hangs, WORLD, (fail_rank,), timeout=timeout)
    assert time.monotonic() - t0 < 120
