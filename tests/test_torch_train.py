"""The port's training step (instance_segmentation_torch/training/train_step.py)
and its parts against the JAX package on seeded numpy inputs, float32:
train-mode batch norm and its running statistics against flax, drop-connect,
the optimizer menu (Adam, SGD, Adadelta) against ``make_optimizer``, the weight bridge
both ways, and one whole step (EfficientSeg-B0, 128x512, B=2, M=8, P=64)
against the loss function of ``make_train_step`` (built with
``backbone_s2d=False, unet_s2d=False``; the Pallas kernels in interpret
mode): the six stats, every gradient leaf and the new batch statistics.

Drop-connect draws differ between the two RNGs, so the whole-step case runs
with it off on both sides: the port at rate 0, JAX with
``efficientnet.drop_connect`` patched to the identity.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instance_segmentation_tpu.models import layers as jl
from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig
from instance_segmentation_torch.models import layers as tl
from instance_segmentation_torch.training.train_step import Trainer, make_optimizer
from instance_segmentation_torch.weights import (
    export_flax_variables, load_flax_variables, port_tensors_from_flax,
)

from test_torch_losses import octagon_labels
from test_torch_model import random_flax_variables

torch.set_num_threads(2)
B, H, W, M, P = 2, 128, 512, 8, 64
STAT_TOL = dict(rtol=1e-4, atol=0.0)
GRAD_TOL = 1e-3                                 # of the step's max|g| (see below)
BN_TOL = dict(rtol=1e-5, atol=1e-6)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


@pytest.mark.parametrize("kind", ["det", "unet"])
def test_batchnorm_train_matches_flax(kind):
    eps, momentum = {"det": (tl.BN_EPS_DET, tl.BN_MOMENTUM_DET),
                     "unet": (tl.BN_EPS_UNET, tl.BN_MOMENTUM_UNET)}[kind]
    assert (jl.BN_MOMENTUM_DET, jl.BN_MOMENTUM_UNET) == (tl.BN_MOMENTUM_DET,
                                                         tl.BN_MOMENTUM_UNET)
    rng = np.random.default_rng(0)
    c = 6
    x = rng.normal(0.7, 1.3, (3, 9, 11, c)).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.normal(0, 0.2, c).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.2, c).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    jm = jl.BatchNorm(momentum=momentum, epsilon=eps)
    y_j, mutated = jm.apply({"params": {"BatchNorm_0": params},
                             "batch_stats": {"BatchNorm_0": stats}}, jnp.asarray(x),
                            train=True, mutable=["batch_stats"])
    bn = tl.BatchNorm(c, eps=eps, momentum=momentum)
    with torch.no_grad():
        for name, v in (("weight", params["scale"]), ("bias", params["bias"]),
                        ("running_mean", stats["mean"]), ("running_var", stats["var"])):
            getattr(bn, name).copy_(torch.from_numpy(v))
    y_t = bn.train()(_nchw(x))
    np.testing.assert_allclose(y_t.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y_j),
                               **BN_TOL)
    new = mutated["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new["mean"]), **BN_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new["var"]), **BN_TOL)
    # eval mode reads the (new) running statistics and leaves them alone
    before = bn.running_var.clone()
    bn.eval()(_nchw(x))
    assert torch.equal(bn.running_var, before)


def test_drop_connect_mask_and_scaling():
    rate, n = 0.3, 4096
    x = torch.ones((n, 2, 3, 3))
    gen = torch.Generator().manual_seed(0)
    y = tl.drop_connect(x, rate, gen)
    per_sample = y.reshape(n, -1)
    assert bool((per_sample == per_sample[:, :1]).all())         # one draw per sample
    values = set(np.unique(per_sample.numpy()).tolist())
    assert values <= {0.0, np.float32(1.0 / (1.0 - rate))}
    kept = float((per_sample[:, 0] > 0).float().mean())
    assert abs(kept - (1.0 - rate)) < 4 * np.sqrt(rate * (1 - rate) / n)
    again = tl.drop_connect(x, rate, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)
    assert tl.drop_connect(x, 0.0, gen) is x


def test_drop_connect_rates_and_modes():
    from instance_segmentation_torch.models.efficientnet import EfficientNetFeatures
    net = EfficientNetFeatures(0, drop_connect_rate=0.2)
    total = len(net._blocks)
    assert [b.drop_rate for b in net._blocks] == [0.2 * i / total for i in range(total)]
    x = torch.randn(4, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    net.train()
    net.generator = torch.Generator().manual_seed(2)
    a = net(x)[-1]
    net.generator = torch.Generator().manual_seed(3)
    b = net(x)[-1]
    assert not torch.equal(a, b)                                   # stochastic in training
    net.eval()
    assert torch.equal(net(x)[-1], net(x)[-1])


@pytest.mark.parametrize("opt_type, lr", [("Adam", 2e-5), ("SGD", 2e-5), ("Adadelta", 1.0)])
def test_adam_matches_optax_over_three_updates(opt_type, lr):
    """The port's optimizer menu against the reference's ``make_optimizer``:
    three updates to atol 1e-7 (Adadelta at lr 1, where its steps of ~3e-3
    show; at 2e-5 they would round away in float32); any other name raises
    ValueError in both."""
    import optax
    from instance_segmentation_tpu.parallel.train_step import make_optimizer as j_make
    rng = np.random.default_rng(4)
    shapes = {"w": (5, 3), "bn_scale": (7,), "fusion": (2,)}
    params = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(0, 1e-2, s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    tx = j_make(opt_type, lr)
    p_j = jax.tree.map(jnp.asarray, params)
    state = tx.init(p_j)
    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(list(tensors.values()), opt_type, lr)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, p_j)
        p_j = optax.apply_updates(p_j, updates)
        for k, t in tensors.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
    for k, t in tensors.items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(p_j[k]), rtol=0, atol=1e-7)
        assert not np.array_equal(t.detach().numpy(), params[k])
    with pytest.raises(ValueError, match="unknown optimizer"):
        j_make("RMSprop")
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(list(tensors.values()), "RMSprop")


# ---- the whole step --------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_case():
    """Seeded weights, frames and labels; the JAX step's stats, gradients and
    new batch statistics; and a port Trainer after compute_grads."""
    import instance_segmentation_tpu.losses.ae_pallas as aep
    import instance_segmentation_tpu.losses.rasterize_pallas as rp
    import instance_segmentation_tpu.models.efficientnet as jeff
    from instance_segmentation_tpu.losses import LossConfig, compose_loss
    from instance_segmentation_tpu.models import EfficientSeg as JaxSeg
    from instance_segmentation_tpu.models import EfficientSegConfig as JaxCfg
    from instance_segmentation_tpu.models import generate_anchors
    from instance_segmentation_tpu.ops.targets import generate_targets

    model = JaxSeg(JaxCfg(num_classes=8, compound_coef=0, backbone_s2d=False, unet_s2d=False))
    frames = np.random.default_rng(20).integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    variables = random_flax_variables(model, jnp.asarray(frames), train=False, seed=21)
    labels = octagon_labels(seed=22)
    anchors = jnp.asarray(generate_anchors(H, W, pyramid_levels=model.cfg.pyramid_levels,
                                           anchor_scale=model.cfg.anchor_scale))

    def loss_fn(params, batch_stats, images, polys, n_verts, cls_ids):
        targets = generate_targets(polys, n_verts, cls_ids, H, W, max_points=P,
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
    trainer = Trainer(EfficientSegConfig(num_classes=8, compound_coef=0, drop_connect_rate=0.0),
                      variables, (H, W), max_points=P, device=torch.device("cpu"))
    got = trainer.compute_grads(frames, *labels)
    return {"stats": stats, "grads": grads, "batch_stats": new_bs, "trainer": trainer,
            "got": got, "variables": variables, "frames": frames, "labels": labels}


def test_train_step_stats_match_jax(step_case):
    got, want = step_case["got"], step_case["stats"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert bool(torch.isfinite(got[k]))
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **STAT_TOL)


def test_train_step_gradients_match_jax(step_case):
    """Every gradient leaf within 1e-3 of the step's max|g| (taken over all
    leaves), and the whole gradient within 1e-3 in relative L2 norm.

    Not "1e-3 of each leaf's own max|g|": in float32 that bound is out of
    reach for leaves whose gradient is far smaller than the gradient flowing
    through them. A conv bias or shift followed by a train-mode batch norm
    has an exactly zero gradient (the norm removes a per-channel constant),
    so both packages return rounding noise there; and deep U-Net and
    backbone leaves keep what is left after batch norm's backward projects
    out most of the incoming gradient. The port alone, run with 1 thread
    instead of 2 (another summation order), moves such leaves by up to 4e-3
    of their own max; against JAX the largest is 1.5e-2 of its own max,
    8.8e-5 of the step's max."""
    model = step_case["trainer"].model
    want = port_tensors_from_flax(model, {"params": step_case["grads"]})
    params = dict(model.named_parameters())
    assert sorted(want) == sorted(params)
    top = max(float(w.abs().max()) for w in want.values())
    sq_err = sq_ref = 0.0
    for key, w in want.items():
        g = params[key].grad
        assert g is not None and g.dtype == torch.float32, key
        err = float((g - w).abs().max())
        assert err <= GRAD_TOL * top, (key, err, top)
        if float(w.abs().max()) <= 1e-6 * top:          # exactly zero: noise on both sides
            assert float(g.abs().max()) <= 1e-5 * top, key
        sq_err += float(((g - w) ** 2).sum())
        sq_ref += float((w ** 2).sum())
    assert sq_err ** 0.5 <= GRAD_TOL * sq_ref ** 0.5


def test_train_step_batch_stats_match_jax(step_case):
    model = step_case["trainer"].model
    want = port_tensors_from_flax(model, {"batch_stats": step_case["batch_stats"]})
    buffers = dict(model.named_buffers())
    assert len(want) == sum(1 for k in buffers if k.endswith(("running_mean", "running_var")))
    for key, w in want.items():
        np.testing.assert_allclose(buffers[key].numpy(), w.numpy(), err_msg=key, **BN_TOL)


def test_train_step_updates_with_adam(step_case):
    """A step after compute_grads moves every parameter that got a gradient
    by at most about lr (Adam's first step is lr * sign(g) in size; the
    difference of two float32 parameters near 1 carries ~1e-7 of rounding)."""
    trainer = step_case["trainer"]
    before = {k: p.detach().clone() for k, p in trainer.model.named_parameters()}
    trainer.optimizer.step()
    for k, p in trainer.model.named_parameters():
        delta = (p.detach() - before[k]).abs().max()
        assert float(delta) <= 2e-5 + 5e-7, k
    moved = sum(not torch.equal(p.detach(), before[k])
                for k, p in trainer.model.named_parameters())
    assert moved > 0.9 * len(before)


def test_export_flax_variables_round_trip(step_case):
    variables = step_case["variables"]
    model = EfficientSeg(EfficientSegConfig(num_classes=8, compound_coef=0))
    load_flax_variables(model, variables)
    exported = export_flax_variables(model)
    want = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(exported)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        g = got[path]
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(leaf), err_msg=jax.tree_util.keystr(path))


def test_bf16_compute_keeps_f32_master_weights():
    """bf16 compute with f32 master weights on the CPU, at a tiny size: every
    gradient is float32 and finite and the loss stats are finite."""
    h, w = 128, 128
    trainer = Trainer(EfficientSegConfig(num_classes=8, compound_coef=0,
                                         compute_dtype=torch.bfloat16),
                      torch.Generator().manual_seed(0), (h, w), max_points=32,
                      device=torch.device("cpu"))
    conv = trainer.model.kp_header.double_conv1[0]
    assert conv.weight.dtype == torch.float32
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8)
    polys = np.zeros((1, 4, 4, 2), np.float32)
    polys[0, 0] = [[10, 20], [10, 60], [40, 60], [40, 20]]
    polys[0, 1:] = polys[0, 0, 0]
    stats = trainer.step(frames, polys, np.array([[4, 0, 0, 0]]), np.array([[3, -1, -1, -1]]))
    assert all(bool(torch.isfinite(v)) for v in stats.values())
    for p in trainer.model.parameters():
        assert p.dtype == torch.float32
        assert p.grad is None or (p.grad.dtype == torch.float32
                                  and bool(torch.isfinite(p.grad).all()))


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(EfficientSegConfig(compound_coef=0), torch.Generator().manual_seed(0), (64, 128))


def test_trainer_rejects_bad_frames(step_case):
    trainer = step_case["trainer"]
    frames = step_case["frames"]
    with pytest.raises(ValueError, match="uint8"):
        trainer.step(frames.astype(np.float32), *step_case["labels"])
