"""Port layers (instance_segmentation_torch/models/layers.py) against their
flax counterparts on the same seeded numpy inputs and weights, float32, to
1e-5; and eval batch norm as one pass (``kernels/bn_act.py``): the op's CPU
twin against the composition, the activation fused into the norm, the
coefficients a frozen norm keeps and what changes them, and which calls go
to the op (fake CUDA tensors)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from instance_segmentation_tpu.models import layers as jl
from instance_segmentation_torch.kernels import bn_act
from instance_segmentation_torch.models import layers as tl
from instance_segmentation_torch.weights import conv_kernel_from_flax

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
SIZES = [(12, 16), (13, 17)]          # even and odd


def _nhwc(rng, shape, lo=-2.0, hi=2.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _to_torch(x_nhwc):
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def _to_nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _set_conv(conv, flax_conv_params):
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(conv_kernel_from_flax(
            np.array(flax_conv_params["kernel"]))))
        if "bias" in flax_conv_params:
            conv.bias.copy_(torch.from_numpy(np.array(flax_conv_params["bias"])))


def _bn_variables(rng, c):
    return ({"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
             "bias": rng.normal(0, 0.2, c).astype(np.float32)},
            {"mean": rng.normal(0, 0.2, c).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)})


def _set_bn(bn, params, stats):
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))


@pytest.mark.parametrize("depthwise", [False, True], ids=["dense", "depthwise"])
@pytest.mark.parametrize("size", SIZES, ids=["even", "odd"])
@pytest.mark.parametrize("kernel", [1, 3, 5])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_same_matches_flax(stride, kernel, size, depthwise):
    rng = np.random.default_rng(kernel * 10 + stride)
    cin = 6
    cout = cin if depthwise else 5
    groups = cin if depthwise else 1
    x = _nhwc(rng, (2, *size, cin))
    jm = jl.ConvSame(cout, (kernel, kernel), strides=(stride, stride), groups=groups,
                     use_bias=not depthwise)
    v = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    if not depthwise:
        v["params"]["Conv_0"]["bias"] = rng.normal(0, 0.5, cout).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))

    tm = tl.Conv2dSame(cin, cout, kernel, stride, groups=groups, bias=not depthwise)
    _set_conv(tm.conv, v["params"]["Conv_0"])
    got = _to_nhwc(tm(_to_torch(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("size", SIZES + [(2, 3), (1, 1)],
                         ids=["even", "odd", "tiny", "single"])
def test_max_pool_same_zero_padding_matches_flax(size):
    # all-negative inputs: the zero padding (not -inf) shows at the borders
    x = _nhwc(np.random.default_rng(1), (2, *size, 3), lo=-3.0, hi=-0.5)
    want = np.asarray(jl.max_pool_same(jnp.asarray(x)))
    got = _to_nhwc(tl.max_pool_same(_to_torch(x)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (got == 0.0).any()


@pytest.mark.parametrize("size", SIZES, ids=["even", "odd"])
def test_upsample_nearest_2x_matches_flax(size):
    x = _nhwc(np.random.default_rng(2), (2, *size, 3))
    want = np.asarray(jl.upsample_nearest_2x(jnp.asarray(x)))
    got = _to_nhwc(tl.upsample_nearest_2x(_to_torch(x)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("eps", [tl.BN_EPS_DET, tl.BN_EPS_UNET], ids=["det", "unet"])
def test_batchnorm_eval_matches_flax(eps):
    assert (jl.BN_EPS_DET, jl.BN_EPS_UNET) == (tl.BN_EPS_DET, tl.BN_EPS_UNET)
    rng = np.random.default_rng(3)
    c = 7
    x = _nhwc(rng, (2, 5, 6, c))
    params, stats = _bn_variables(rng, c)
    jm = jl.BatchNorm(epsilon=eps)
    want = np.asarray(jm.apply({"params": {"BatchNorm_0": params},
                                "batch_stats": {"BatchNorm_0": stats}},
                               jnp.asarray(x), train=False))
    tm = tl.BatchNorm(c, eps=eps)
    _set_bn(tm, params, stats)
    np.testing.assert_allclose(_to_nhwc(tm(_to_torch(x))), want, **TOL)


def test_swish_matches_flax():
    x = _nhwc(np.random.default_rng(4), (1, 4, 5, 3), lo=-8.0, hi=8.0)
    want = np.asarray(jl.swish(jnp.asarray(x)))
    np.testing.assert_allclose(_to_nhwc(tl.swish(_to_torch(x))), want, **TOL)


@pytest.mark.parametrize("activation", [False, True], ids=["linear", "swish"])
@pytest.mark.parametrize("norm", [False, True], ids=["plain", "bn"])
def test_separable_conv_matches_flax(norm, activation):
    rng = np.random.default_rng(5)
    cin, cout = 6, 4
    x = _nhwc(rng, (2, 9, 10, cin))
    jm = jl.SeparableConv(cout, norm=norm, activation=activation)
    v = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    v["params"]["pointwise"]["Conv_0"]["bias"] = rng.normal(0, 0.5, cout).astype(np.float32)
    if norm:
        params, stats = _bn_variables(rng, cout)
        v["params"]["bn"]["BatchNorm_0"] = params
        v["batch_stats"]["bn"]["BatchNorm_0"] = stats
    want = np.asarray(jm.apply(v, jnp.asarray(x)))

    tm = tl.SeparableConv(cin, cout, norm=norm, activation=activation)
    _set_conv(tm.depthwise_conv.conv, v["params"]["depthwise"]["Conv_0"])
    _set_conv(tm.pointwise_conv.conv, v["params"]["pointwise"]["Conv_0"])
    if norm:
        _set_bn(tm.bn, params, stats)
    np.testing.assert_allclose(_to_nhwc(tm(_to_torch(x))), want, **TOL)



# ---------------------------------------------------------------------------
# Eval batch norm as one pass (kernels/bn_act.py): the op's CPU twin, the
# fused activation, the kept coefficients and the route to the op
# ---------------------------------------------------------------------------

ACTIVATIONS = {"none": lambda y: y, "silu": F.silu, "relu": F.relu, "gelu": F.gelu}


def _bn(c=8, eps=tl.BN_EPS_DET, seed=7):
    rng = np.random.default_rng(seed)
    bn = tl.BatchNorm(c, eps=eps)
    _set_bn(bn, *_bn_variables(rng, c))
    return bn


def _x(dtype=torch.float32, channels_last=False, shape=(2, 8, 5, 6), seed=8):
    x = torch.from_numpy(np.random.default_rng(seed).normal(0, 3, shape).astype(np.float32))
    x = x.to(dtype)
    return x.contiguous(memory_format=torch.channels_last) if channels_last else x


def _composition(bn, x, mean, var):
    """The eval batch norm as the port wrote it before the op: the float32
    coefficients cast and broadcast, a multiply and an add."""
    scale = bn.weight * torch.rsqrt(var + bn.eps)
    shift = bn.bias - mean * scale
    return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "nhwc"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("act", ["none", "silu", "relu", "gelu", "gate"])
def test_bn_act_cpu_twin_is_the_composition(act, dtype, channels_last):
    x = _x(dtype, channels_last)
    rng = np.random.default_rng(9)
    if act == "gate":
        s = torch.from_numpy(rng.normal(0, 2, (2, 8, 1, 1)).astype(np.float32)).to(dtype)
        got = bn_act.bn_act(x, torch.sigmoid(s).reshape(2, 8))
        want = torch.sigmoid(s) * x
    else:
        scale, shift = (torch.from_numpy(rng.normal(0, 1, 8).astype(np.float32)).to(dtype)
                        for _ in range(2))
        got = bn_act.bn_act(x, scale, shift, act)
        want = ACTIVATIONS[act](x * scale[:, None, None] + shift[:, None, None])
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("mode", ["frozen", "eval_grad", "training"])
@pytest.mark.parametrize("act", ["none", "silu", "relu", "gelu"])
def test_batchnorm_with_act_equals_the_activation_after_it(act, mode):
    x = _x(torch.bfloat16)
    fused, plain = _bn(), _bn()
    for bn in (fused, plain):
        bn.train(mode == "training")
    with torch.set_grad_enabled(mode != "frozen"):
        got = fused(x, act=act)
        want = ACTIVATIONS[act](plain(x))
    assert torch.equal(got, want)
    assert torch.equal(fused.running_mean, plain.running_mean)
    assert torch.equal(fused.running_var, plain.running_var)


def test_linear_and_layer_norm_follow_the_dtype_policy():
    """``cast_convs`` holds a linear layer in the compute dtype and leaves a
    layer norm in float32; both cast to the input's dtype per call."""
    g = torch.Generator().manual_seed(5)
    net = torch.nn.Sequential(tl.LayerNorm(8), tl.Linear(8, 12))
    for p in net.parameters():
        p.data.copy_(torch.randn(p.shape, generator=g))
    tl.cast_convs(net, torch.bfloat16)
    norm, linear = net
    assert linear.weight.dtype == linear.bias.dtype == torch.bfloat16
    assert norm.weight.dtype == norm.bias.dtype == torch.float32
    x = torch.randn(2, 3, 8, generator=g).to(torch.bfloat16)
    with torch.no_grad():
        y = net(x)
    want = F.linear(F.layer_norm(x, (8,), norm.weight.to(x.dtype), norm.bias.to(x.dtype),
                                 1e-5), linear.weight, linear.bias)
    assert y.dtype == torch.bfloat16 and torch.equal(y, want)


def _load_state(bn):
    state = {k: v + 0.25 for k, v in bn.state_dict().items()}
    bn.load_state_dict(state)


CHANGES = {
    "weight": lambda bn: bn.weight.mul_(1.5), "bias": lambda bn: bn.bias.add_(0.5),
    "running_mean": lambda bn: bn.running_mean.add_(0.5),
    "running_var": lambda bn: bn.running_var.mul_(2.0), "load_state_dict": _load_state,
    "training_step": lambda bn: (bn.train(), bn(_x()), bn.eval()),
}


def _kept(bn, dtype=torch.bfloat16):
    """The coefficient tensors ``bn`` keeps for ``dtype`` on the CPU."""
    return bn._kept[(dtype, torch.device("cpu"))][1:]


@pytest.mark.parametrize("change", list(CHANGES))
def test_frozen_coefficients_follow_a_change_made_in_place(change):
    """The next frozen call after a change forms the coefficients anew and
    writes them into the tensors kept before, where a captured graph reads
    them."""
    bn, x = _bn(), _x(torch.bfloat16)
    with torch.no_grad():
        before = bn(x, act="silu")
        scale, shift = kept = _kept(bn)
        assert torch.equal(bn(x, act="silu"), before)
        assert all(a is b for a, b in zip(_kept(bn), kept))
        CHANGES[change](bn)
        after = bn(x, act="silu")
    want = F.silu(_composition(bn, x, bn.running_mean, bn.running_var)).detach()
    assert torch.equal(after, want) and not torch.equal(after, before)
    assert all(a is b for a, b in zip(_kept(bn), kept))
    assert torch.equal(F.silu(x * scale[:, None, None] + shift[:, None, None]), want)


def test_frozen_coefficients_kept_in_inference_mode_are_rewritten_outside_it():
    """Coefficients first kept under ``torch.inference_mode`` (as a served
    request keeps them) are ordinary tensors: a frozen call outside it
    rewrites them after a change; each dtype keeps a pair of its own."""
    bn, x = _bn(), _x(torch.bfloat16)
    with torch.inference_mode():
        bn(x)
        bn(x.float())
    kept, kept_f32 = _kept(bn), _kept(bn, torch.float32)
    f32_before = [t.clone() for t in kept_f32]
    assert not any(t.is_inference() for t in (*kept, *kept_f32))
    assert kept[0].dtype == torch.bfloat16 and kept_f32[0].dtype == torch.float32
    with torch.no_grad():
        bn.weight.mul_(1.5)
        got = bn(x)
    assert torch.equal(got, _composition(bn, x, bn.running_mean, bn.running_var).detach())
    assert all(a is b for a, b in zip(_kept(bn), kept))
    assert all(torch.equal(a, b) for a, b in zip(kept_f32, f32_before))


def test_frozen_coefficients_are_formed_under_a_dispatch_mode():
    """A FLOP counter sees what the forward runs: the coefficients formed
    on the first frozen call, and read from what it kept on the next."""
    from instance_segmentation_torch.utils.flops import OpCounter
    bn, x = _bn(), _x()
    with torch.no_grad():
        with OpCounter() as first:
            bn(x)
        with OpCounter() as warm:
            bn(x)
    assert "aten::rsqrt" in [o.name for o in first.ops]
    assert [o.name for o in warm.ops] == ["iseg::bn_act"]


@pytest.mark.parametrize("mode", ["eval_grad", "training"])
def test_batchnorm_with_grad_keeps_the_composition_and_its_gradients(mode, monkeypatch):
    monkeypatch.setattr(bn_act, "bn_act", lambda *a: pytest.fail("the op was called"))
    bn, ref = _bn(), _bn()
    for m in (bn, ref):
        m.train(mode == "training")
    x, x_ref = _x().requires_grad_(True), _x().requires_grad_(True)
    y = bn(x, act="silu")
    if mode == "training":
        xf = x_ref.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp_min(xf.square().mean(dim=(0, 2, 3)) - mean.square(), 0.0)
    else:
        mean, var = ref.running_mean, ref.running_var
    want = F.silu(_composition(ref, x_ref, mean, var))
    assert torch.equal(y, want)
    g = torch.from_numpy(np.random.default_rng(10).normal(0, 1, y.shape).astype(np.float32))
    y.backward(g)
    want.backward(g)
    for a, b in ((x.grad, x_ref.grad), (bn.weight.grad, ref.weight.grad),
                 (bn.bias.grad, ref.bias.grad)):
        assert torch.equal(a, b)
    assert not bn._kept


def _fake_cuda_strided():
    return torch.empty_strided((2, 8, 6, 5), (480, 60, 10, 2), dtype=torch.bfloat16,
                               device="cuda")


def test_bn_act_takes_cuda_tensors_it_reads():
    """The kernel reads contiguous and channels-last ``x`` and refuses any
    other layout, before it reads a byte."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        nchw = torch.empty(2, 8, 6, 10, dtype=torch.bfloat16, device="cuda")
        nhwc = torch.empty_strided((2, 8, 6, 10), (480, 1, 80, 8), dtype=torch.bfloat16,
                                   device="cuda")
        assert bn_act.layout(nchw) == "nchw" and bn_act.layout(nhwc) == "nhwc"
        strided = _fake_cuda_strided()
        assert bn_act.layout(strided) is None
        assert bn_act.layout(torch.empty(8, 6, 10, device="cuda")) is None
        one = torch.ones(8, dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError, match="contiguous or channels-last"):
            bn_act._launch(strided, one, one, "none")


@pytest.fixture
def op_calls(monkeypatch):
    """The arguments of each ``bn_act.bn_act`` call, whose CPU twin runs."""
    seen = []

    def record(x, scale, shift=None, act="none"):
        seen.append((x, scale, shift, act))
        return bn_act.bn_act_plain(x, scale, shift, act)
    monkeypatch.setattr(bn_act, "bn_act", record)
    return seen


@pytest.mark.parametrize("case, calls", [
    ("nchw", 1), ("nhwc", 1), ("strided", 1), ("eval_grad", 0), ("training", 0)])
def test_batchnorm_takes_the_op_only_frozen_on_a_layout_it_reads(case, calls, op_calls):
    """Frozen, a batch norm hands the op every input: the CPU twin takes any
    strides, and on the card the kernel refuses one it cannot read, where a
    slower path would hide it."""
    bn, x = _bn(), _x(torch.bfloat16, channels_last=case == "nhwc", shape=(2, 8, 6, 10))
    if case == "strided":
        x = x[..., ::2]
    bn.train(case == "training")
    with torch.set_grad_enabled(case in ("eval_grad", "training")):
        y = bn(x, act="relu")
    assert len(op_calls) == calls
    bn.eval()
    with torch.no_grad():
        want = F.relu(_composition(bn, x, bn.running_mean, bn.running_var))
    assert case == "training" or torch.equal(y, want)
    if calls:
        assert op_calls[0][3] == "relu" and op_calls[0][1].dtype == torch.bfloat16
    if case == "strided":
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            one = torch.ones(8, dtype=torch.bfloat16, device="cuda")
            with pytest.raises(ValueError, match="contiguous or channels-last"):
                bn_act._launch(_fake_cuda_strided(), one, one, "relu")


@pytest.mark.parametrize("mode", ["frozen", "training"])
def test_mbconv_gate_takes_the_op_when_frozen(mode, op_calls):
    """An MBConv with squeeze-and-excitation: frozen, its three batch norms
    and its gate (a scale per image and channel) take the op, and give what
    the composition gives; in training none does."""
    from instance_segmentation_torch.models.efficientnet import BlockArgs, MBConv
    block = MBConv(BlockArgs(3, 1, 16, 16, 6, 1, 0.25)).train(mode == "training")
    x = _x(shape=(2, 16, 8, 8))
    with torch.set_grad_enabled(mode == "training"):
        y = block(x)
    if mode == "training":
        assert not op_calls
        return
    assert [(tuple(a[1].shape), a[2] is None, a[3]) for a in op_calls] == [
        ((96,), False, "silu"), ((96,), False, "silu"), ((2, 96), True, "none"),
        ((16,), False, "none")]
    with torch.enable_grad():
        assert torch.equal(y, block(x))       # eval with grad: the composition
