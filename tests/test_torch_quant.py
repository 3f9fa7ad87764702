"""The port's int8 inference path (models/layers.py ``int8_conv2d``, the
``quant="int8"`` model) against the JAX package's ``_Int8Conv`` and int8
EfficientSeg on the same numpy weights and inputs.

Tolerances: the int32 accumulators of one conv are equal, and its output is
bitwise equal to the JAX module's evaluated op by op. Under ``jax.jit`` XLA
rewrites ``m / 127`` into ``m * (1 / 127)`` and folds the dequantization
scale as ``s_w * (max|x| * (1 / 127^2))``, so the jitted module differs in
the last bits: held to ``JIT_TOL`` of the output's largest magnitude. The
whole B0 int8 model is held to the jitted JAX int8 model to ``MODEL_TOL``
of each output's largest magnitude: one int8 step that a last-bit
difference moves propagates, and the JAX package's own op-by-op and jitted
int8 forwards differ by up to 0.031 on this case (kp 0.026, ae 0.023, tan
0.031); int8 against float to ``test_quant.py``'s 0.15. JAX is imported
inside the tests that use it, so that the card test (marked ``cuda``) runs
where JAX is not installed."""

import numpy as np
import pytest
import torch

from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig
from instance_segmentation_torch.models.layers import (
    Conv2d, int8_accumulate, int8_conv2d, quantize_int8,
)
from instance_segmentation_torch.weights import conv_kernel_from_flax, load_flax_variables

from torch_cases import cuda_device  # noqa: F401 (a fixture)

torch.set_num_threads(2)
H, W = 128, 256
JIT_TOL = 1e-6            # of the conv output's largest magnitude
MODEL_TOL = 5e-2          # of each output's largest magnitude
FLOAT_TOL = 0.15          # tests/test_quant.py:66


def _jax_accumulators(x, kernel):
    """JAX ``_Int8Conv``'s int32 accumulators, its own lines."""
    import jax
    import jax.numpy as jnp
    s_w = jnp.maximum(jnp.max(jnp.abs(kernel), axis=(0, 1, 2)), 1e-8) / 127.0
    w_q = jnp.round(kernel / s_w).astype(jnp.int8)
    s_x = jnp.maximum(jnp.max(jnp.abs(x.astype(jnp.float32))), 1e-8) / 127.0
    x_q = jnp.clip(jnp.round(x.astype(jnp.float32) / s_x), -127, 127).astype(jnp.int8)
    return jax.lax.conv_general_dilated(
        x_q, w_q, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)


@pytest.mark.parametrize("kind", ["1x1", "3x3_K171"])
def test_int8_conv_equals_jax(kind):
    """One conv of each kind the model quantizes: an MBConv 1x1 (no bias)
    and the U-Net input stage's 3x3 over 19 channels (K = 171, with bias)."""
    import jax
    import jax.numpy as jnp
    from instance_segmentation_tpu.models.layers import ConvSame
    rng = np.random.default_rng(7)
    k, cin, cout, bias = (1, 40, 240, False) if kind == "1x1" else (3, 19, 16, True)
    x = rng.normal(0, 2, (2, 12, 20, cin)).astype(np.float32)
    x[0, 0, 0, 0] = 9.5                                  # a clear abs-max
    conv = ConvSame(features=cout, kernel_size=(k, k), use_bias=bias, quant=True)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = rng.normal(0, 0.2, (k, k, cin, cout)).astype(np.float32)
    params = {"kernel": kernel}
    if bias:
        params["bias"] = rng.normal(0, 0.1, cout).astype(np.float32)
    v = {"params": {"Conv_0": params}}
    want_y = np.asarray(conv.apply(v, jnp.asarray(x)))
    jit_y = np.asarray(jax.jit(conv.apply)(v, jnp.asarray(x)))
    want_acc = np.asarray(_jax_accumulators(jnp.asarray(x), jnp.asarray(kernel)))

    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    wt = torch.from_numpy(conv_kernel_from_flax(kernel))
    bt = torch.from_numpy(params["bias"]) if bias else None
    x_q, _, w_q, _ = quantize_int8(xt, wt)
    acc = int8_accumulate(x_q, w_q, k // 2)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(), want_acc)
    y = int8_conv2d(xt, wt, bt, k // 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(y, want_y)
    assert np.abs(y - jit_y).max() <= JIT_TOL * np.abs(jit_y).max()


def test_int8_conv_rounds_half_to_even_and_clips():
    w = torch.full((1, 1, 1, 1), 0.5)
    x = torch.tensor([[[[127.0, 0.5, 1.5, -2.5, -127.0]]]]).permute(0, 3, 1, 2)
    x_q, s_x, w_q, s_w = quantize_int8(x, w)
    assert float(s_x) == np.float32(127.0) / np.float32(127.0)
    assert x_q.flatten().tolist() == [127, 0, 2, -2, -127]
    assert w_q.item() == 127 and float(s_w) == np.float32(0.5) / np.float32(127.0)


def test_int8_conv_refuses_what_the_path_does_not_take():
    with pytest.raises(ValueError, match="dense stride-1"):
        Conv2d(8, 8, 3, stride=2, quant=True)
    with pytest.raises(ValueError, match="dense stride-1"):
        Conv2d(8, 8, 3, groups=8, quant=True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        int8_accumulate(torch.zeros(1, 8, 4, 4, dtype=torch.int8, device="meta"),
                        torch.zeros(8, 8, 1, 1, dtype=torch.int8, device="meta"), 0)
    with pytest.raises(ValueError, match="quant"):
        EfficientSegConfig(quant="int4")


@pytest.fixture(scope="module")
def b0_pair():
    import jax
    import jax.numpy as jnp
    from instance_segmentation_tpu.models import EfficientSeg as JSeg
    from instance_segmentation_tpu.models import EfficientSegConfig as JCfg
    from test_torch_model import random_flax_variables
    jcfg_f = JCfg(num_classes=4, compound_coef=0)
    jcfg_q = JCfg(num_classes=4, compound_coef=0, quant="int8")
    x = np.random.default_rng(5).integers(0, 255, (1, H, W, 3), dtype=np.uint8)
    variables = random_flax_variables(JSeg(jcfg_f), jnp.asarray(x), train=False, seed=3)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    want_q = jax.jit(lambda v, a: JSeg(jcfg_q).apply(v, a, train=False))(variables, x)
    return x, variables, [np.asarray(o) for o in want_q]


def _port(variables, quant):
    model = EfficientSeg(EfficientSegConfig(num_classes=4, compound_coef=0, quant=quant))
    load_flax_variables(model, variables)
    return model.eval()


def test_int8_model_matches_jax_int8_and_stays_near_float(b0_pair):
    x, variables, want_q = b0_pair
    images = torch.from_numpy(x)
    with torch.no_grad():
        got_q = _port(variables, "int8")(images)
        got_f = _port(variables, "none")(images)
    for name, g, w, f in zip(("kp", "ae", "tan", "regression", "classification"),
                             got_q, want_q, got_f):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        scale = float(np.abs(w).max()) + 1e-6
        err = float(np.abs(g.numpy() - w).max()) / scale
        assert err <= MODEL_TOL, (name, err)
        if name in ("kp", "ae", "tan"):
            err_f = float((g - f).abs().max()) / (float(f.abs().max()) + 1e-6)
            assert err_f < FLOAT_TOL, (name, err_f)


def test_int8_model_loads_the_float_state_dict_and_keeps_float32_weights(b0_pair):
    _, variables, _ = b0_pair
    fl = _port(variables, "none")
    q = EfficientSeg(EfficientSegConfig(num_classes=4, compound_coef=0, quant="int8",
                                        compute_dtype=torch.bfloat16))
    assert set(q.state_dict()) == set(fl.state_dict())
    q.load_state_dict(fl.state_dict())
    quantized = {n for n, m in q.named_modules() if getattr(m, "quant", False)}
    # the MBConv expand/project convs and every U-Net 3x3 conv, nothing else
    assert all(n.endswith(("_expand_conv.conv", "_project_conv.conv"))
               or ".double_conv" in n for n in quantized)
    assert sum(".double_conv" in n for n in quantized) == 10
    for n, m in q.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            assert m.weight.dtype == (torch.float32 if n in quantized else torch.bfloat16), n


def test_train_mode_does_not_quantize_and_gradients_are_finite(b0_pair, monkeypatch):
    x, variables, _ = b0_pair
    model = _port(variables, "int8").train()
    calls = []
    import instance_segmentation_torch.models.layers as layers
    real = layers.int8_conv2d
    monkeypatch.setattr(layers, "int8_conv2d", lambda *a: calls.append(1) or real(*a))
    out = model(torch.from_numpy(x))
    (out[0] ** 2).sum().backward()
    assert not calls
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert grads and all(bool(torch.isfinite(g).all()) for g in grads)
    model.eval()
    with torch.no_grad():
        model(torch.from_numpy(x))
    assert len(calls) == sum(getattr(m, "quant", False) for m in model.modules())


def test_entry_points_take_int8(monkeypatch):
    """``evaluate``/``test`` (``seeded_model`` with ``tpu.quant: int8``, which
    raised before) and ``serve.Predictor`` run the int8 path."""
    from instance_segmentation_torch import evaluate
    from instance_segmentation_torch.configs import Config
    from instance_segmentation_torch.ops.decode import DecodeConfig
    from instance_segmentation_torch.serve import Predictor
    import instance_segmentation_torch.models.layers as layers

    cfg = Config({"compound_coef": 0, "seed": 3, "tpu": {"quant": "int8"}})
    model = evaluate.seeded_model(cfg, 8, torch.device("cpu"))
    assert model.cfg.quant == "int8" and model.cfg.compute_dtype == torch.bfloat16
    assert not model.training
    n_quant = sum(getattr(m, "quant", False) for m in model.modules())
    assert n_quant > 10

    calls = []
    real = layers.int8_conv2d
    monkeypatch.setattr(layers, "int8_conv2d", lambda *a: calls.append(1) or real(*a))
    pred = Predictor(EfficientSegConfig(num_classes=8, compound_coef=0, quant="int8"),
                     DecodeConfig(kp_th=2000), torch.Generator().manual_seed(0),
                     torch.device("cpu"), orig_hw=(H * 2, W * 2), scale=2.0)
    frames = np.random.default_rng(0).integers(0, 256, (1, H, W, 3), dtype=np.uint8)
    dets = pred.predict(frames)
    assert len(calls) == n_quant and tuple(dets.boxes.shape) == (1, 96, 4)


@pytest.mark.cuda
def test_int8_accumulate_on_card_equals_cpu(cuda_device):
    rng = np.random.default_rng(11)
    for k, cin, cout, hw in ((1, 24, 144, (33, 40)), (3, 19, 16, (64, 96)), (3, 64, 32, (3, 5))):
        x_q = torch.from_numpy(rng.integers(-127, 128, (2, cin, *hw)).astype(np.int8))
        w_q = torch.from_numpy(rng.integers(-127, 128, (cout, cin, k, k)).astype(np.int8))
        want = int8_accumulate(x_q, w_q, k // 2)
        got = int8_accumulate(x_q.to(cuda_device), w_q.to(cuda_device), k // 2)
        assert torch.equal(got.cpu(), want)
