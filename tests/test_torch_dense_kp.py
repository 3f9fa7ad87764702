"""The dense keypoint target and its focal loss against the JAX package on
the CPU, at the loss tests' B0 shapes (B=2, 128x512, M=8, P=64):
``generate_targets(dense_kp=True)`` (the default of both packages) bit for
bit; ``kp_focal_loss`` and its gradient to rtol 1e-5 (the gradient within
1e-5 of its max|g|), on the dense target and on a soft [0, 1] target;
``compose_loss`` through ``targets.kp_tgt`` (JAX :781-782: the dense target
comes before the union map) to rtol 1e-5 against JAX, its head gradients
within 1e-4 of max|g| as ``test_torch_losses.py`` holds them, and its kp
term equal to the union route's (the union map is the dense target's
support) to rtol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instance_segmentation_tpu.losses import losses as jl
from instance_segmentation_tpu.ops.targets import generate_targets as j_generate_targets
from instance_segmentation_torch.losses import losses as tl
from instance_segmentation_torch.ops import targets as tt

from test_torch_losses import (
    B, GRAD_TOL, H, LABELS, P, VALUE_TOL, W, _jax_heads, _port_heads, _rel, head_outputs,
    interpret,  # noqa: F401  (fixture)
)

torch.set_num_threads(2)
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
KP_GRAD_TOL = 1e-5


def dense_targets(labels):
    arrays = LABELS[labels]()
    want = jax.jit(lambda p, n, c: j_generate_targets(p, n, c, H, W, max_points=P))(
        *map(jnp.asarray, arrays))
    got = tt.generate_targets(*map(torch.from_numpy, arrays), H, W, max_points=P)
    return got, want


@pytest.mark.parametrize("labels", list(LABELS))
def test_dense_target_equals_jax(labels):
    got, want = dense_targets(labels)
    assert got.kp_tgt.shape == (B, H, W) and got.kp_tgt.dtype == torch.float32
    np.testing.assert_array_equal(got.kp_tgt.numpy(), np.asarray(want.kp_tgt))
    for name in ("points", "pt_valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    if labels != "empty":
        assert float(got.kp_tgt.sum()) > 0
        # the dense target is the support of the valid samples
        sparse = tt.generate_targets(*map(torch.from_numpy, LABELS[labels]()), H, W,
                                     max_points=P, dense_kp=False)
        assert sparse.kp_tgt is None
        assert torch.equal(sparse.points, got.points)


@pytest.mark.parametrize("target", ["dense", "soft"])
def test_kp_focal_loss_and_gradient_equal_jax(target):
    got_t, want_t = dense_targets("octagons")
    kp = np.random.default_rng(3).normal(-2, 2, (B, H, W, 1)).astype(np.float32)
    tgt = np.array(want_t.kp_tgt)
    if target == "soft":           # values in [0, 1]: the (1 - gt)^4 weight at work
        tgt = np.maximum(tgt, np.random.default_rng(4).uniform(0, 0.9, tgt.shape)
                         .astype(np.float32))
    want, want_g = jax.value_and_grad(jl.kp_focal_loss)(jnp.asarray(kp), jnp.asarray(tgt))
    x = torch.from_numpy(kp).requires_grad_()
    got = tl.kp_focal_loss(x, torch.from_numpy(tgt))
    np.testing.assert_allclose(float(got.detach()), float(want), **LOSS_TOL)
    got.backward()
    assert _rel(x.grad.numpy(), np.asarray(want_g)) <= KP_GRAD_TOL
    planar = tl.kp_focal_loss(torch.from_numpy(kp[..., 0]), torch.from_numpy(tgt))
    assert float(planar) == float(got.detach())


def test_kp_focal_loss_without_positives_equals_jax():
    kp = np.random.default_rng(5).normal(-2, 2, (B, H, W)).astype(np.float32)
    zero = np.zeros((B, H, W), np.float32)
    np.testing.assert_allclose(float(tl.kp_focal_loss(torch.from_numpy(kp),
                                                      torch.from_numpy(zero))),
                               float(jl.kp_focal_loss(jnp.asarray(kp), jnp.asarray(zero))),
                               **LOSS_TOL)


@pytest.mark.parametrize("labels", ["octagons"])
def test_compose_loss_through_the_dense_target_equals_jax(labels, interpret):  # noqa: F811
    got_t, want_t = dense_targets(labels)
    assert got_t.kp_tgt is not None and want_t.kp_tgt is not None
    planes, reg, cls, anchors = head_outputs(seed=6)
    cfg = jl.LossConfig(ae_impl="pallas")

    def loss_j(planes_, reg_, cls_):
        return jl.compose_loss(_jax_heads(planes_, reg_, cls_), want_t, jnp.asarray(anchors), cfg)
    (_, want), grads_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(planes), jnp.asarray(reg), jnp.asarray(cls))
    outputs, leaves = _port_heads(planes, reg, cls)
    total, got = tl.compose_loss(outputs, got_t, torch.tensor(anchors))
    for k in got:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), err_msg=k,
                                   **VALUE_TOL)
    total.backward()
    g_planes = np.stack([t.grad.numpy() for t in leaves])
    for g, w in ((g_planes, grads_j[0]), (outputs[3].grad.numpy(), grads_j[1]),
                 (outputs[4].grad.numpy(), grads_j[2])):
        assert _rel(g, np.asarray(w)) <= GRAD_TOL
    # the same kp term as the union route takes without the dense target
    sparse = got_t._replace(kp_tgt=None)
    outputs, _ = _port_heads(planes, reg, cls)
    _, union = tl.compose_loss(outputs, sparse, torch.tensor(anchors))
    np.testing.assert_allclose(float(got["kp_loss"].detach()), float(union["kp_loss"].detach()),
                               rtol=1e-6)
