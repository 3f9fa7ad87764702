"""The roofline's counts (``utils/flops.py``, ``kernels/bounds.py``) held to
the JAX package, and the roofline tool (``tools/roofline.py``) on the CPU.

(a) The port's FLOP count of the EfficientSeg eval forward (B0 and B3,
    128x256) equals, as an integer, the count read from the JAX package's
    lowered program: every ``stablehlo.convolution`` from its ``tensor<...>``
    types, ``2 x out x window x (rhs input features)``, an lhs-dilated one
    counted on its input (divided by the dilation: the multiplications by
    inserted zeros left out).
(b) Per kind of convolution, the port's backward count equals the
    convolution FLOPs of the lowered JAX ``jax.vjp`` of the same
    ``lax.conv_general_dilated`` (grad-input and grad-weight; each
    convolution's labels read from its ``dim_numbers``), and the forward
    counts agree.
(c) ``kernels/bounds.py`` gives PERF.md's bounds of K1-K6 at the train
    cell's shapes (``torch_cases.TRAIN_SHAPE``, the labels with edge cases).
(d) ``python -m instance_segmentation_torch.tools.roofline --device cpu`` in
    train and ``--eval`` modes at B0 128x256 b2, M=8, P=64: its JSON line
    has the count of ``utils/flops`` and no device measure; and the join of
    ``utils/profiling.roofline`` on a hand-built trace.
No tolerance: FLOPs and bytes are integers.
"""

import json
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

import torch_cases
from instance_segmentation_tpu.models import efficientseg as jseg
from instance_segmentation_torch.kernels import ae_terms, bounds
from instance_segmentation_torch.losses import losses
from instance_segmentation_torch.models import efficientseg as tseg
from instance_segmentation_torch.ops.targets import generate_targets
from instance_segmentation_torch.tools import roofline as roofline_tool
from instance_segmentation_torch.training.synthetic import bench_train_batch
from instance_segmentation_torch.utils import flops, profiling

torch.set_num_threads(2)

_CONV = re.compile(r"stablehlo\.convolution\(.*dim_numbers = \[([^\]]*)\]x\[([^\]]*)\]->"
                   r"\[([^\]]*)\].*: \(tensor<([^>]*)>, tensor<([^>]*)>\) -> tensor<([^>]*)>")
_LHS_DILATE = re.compile(r"lhs_dilate = \[([^\]]*)\]")


def _dims(tensor_type: str):
    return [int(d) for d in tensor_type.split("x")[:-1]]


def stablehlo_conv_flops(text: str):
    """(total FLOPs, number of convolutions) of a StableHLO module's text."""
    total = count = 0
    for line in text.splitlines():
        if "stablehlo.convolution" not in line:
            continue
        m = _CONV.search(line)
        assert m, line
        _, rhs_labels, _, _, rhs_type, out_type = m.groups()
        labels = [x.strip() for x in rhs_labels.split(",")]
        rhs = _dims(rhs_type)
        window = math.prod(d for d, lab in zip(rhs, labels) if lab.isdigit())
        dil = _LHS_DILATE.search(line)
        dilation = math.prod(int(d) for d in dil.group(1).split(",")) if dil else 1
        raw = 2 * math.prod(_dims(out_type)) * window * rhs[labels.index("i")]
        assert raw % dilation == 0, line
        total += raw // dilation
        count += 1
    return total, count


@pytest.mark.parametrize("coef", [0, 3])
def test_forward_flops_equal_the_jax_lowered_program(coef):
    h, w = 128, 256
    jmodel = jseg.EfficientSeg(jseg.EfficientSegConfig(num_classes=8, compound_coef=coef))
    x = jax.ShapeDtypeStruct((1, h, w, 3), jnp.uint8)
    variables = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False), x)
    text = jax.jit(lambda v, x: jmodel.apply(v, x, train=False)).lower(variables, x).as_text()
    want, n_convs = stablehlo_conv_flops(text)
    port = tseg.EfficientSeg(tseg.EfficientSegConfig(num_classes=8, compound_coef=coef)).eval()
    images = torch.zeros((1, h, w, 3), dtype=torch.uint8)
    with torch.no_grad():
        _, ops = flops.count(lambda: port(images))
    convs = [o for o in ops if o.flops]
    assert len(convs) == n_convs
    assert flops.total_flops(ops) == want
    if coef == 0:
        assert want == 2_505_913_088


# (name, Cin, Cout, k, stride, groups, transposed, H, W)
CONV_KINDS = [("3x3 s1", 32, 64, 3, 1, 1, False, 64, 128),
              ("3x3 s2", 32, 64, 3, 2, 1, False, 64, 128),
              ("1x1", 64, 48, 1, 1, 1, False, 64, 128),
              ("depthwise s1", 64, 64, 3, 1, 64, False, 64, 128),
              ("depthwise s2", 64, 64, 3, 2, 64, False, 64, 128),
              ("transposed 2x2 s2", 64, 32, 2, 2, 1, True, 32, 64)]


def _jax_conv(kind):
    """The JAX form of a kind: (conv(x, w), x shape NHWC, w shape HWIO)."""
    _, cin, cout, k, stride, groups, transposed, h, w = kind
    if transposed:       # as flax's ConvTranspose lowers: the input dilated by the stride
        def conv(x, wt):
            return lax.conv_general_dilated(x, wt, (1, 1), [(k - 1, k - 1)] * 2,
                                            lhs_dilation=(stride, stride),
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))
    else:
        pad = k // 2

        def conv(x, wt):
            return lax.conv_general_dilated(x, wt, (stride, stride), [(pad, pad)] * 2,
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                            feature_group_count=groups)
    return conv, (1, h, w, cin), (k, k, cin // groups, cout)


def _torch_conv(kind, x, wt):
    _, cin, cout, k, stride, groups, transposed, h, w = kind
    if transposed:
        return F.conv_transpose2d(x, wt, stride=stride)
    return F.conv2d(x, wt, stride=stride, padding=k // 2, groups=groups)


@pytest.mark.parametrize("kind", CONV_KINDS, ids=[k[0] for k in CONV_KINDS])
def test_backward_flops_equal_the_jax_vjp(kind):
    name, cin, cout, k, stride, groups, transposed, h, w = kind
    conv, x_shape, w_shape = _jax_conv(kind)
    xs = jax.ShapeDtypeStruct(x_shape, jnp.float32)
    ws = jax.ShapeDtypeStruct(w_shape, jnp.float32)
    out = jax.eval_shape(conv, xs, ws)
    fwd, _ = stablehlo_conv_flops(jax.jit(conv).lower(xs, ws).as_text())
    vjp_text = jax.jit(lambda x, wt, g: jax.vjp(conv, x, wt)[1](g)).lower(xs, ws, out).as_text()
    bwd, n_convs = stablehlo_conv_flops(vjp_text)
    assert n_convs == 2                     # grad-input and grad-weight; the forward dropped
    x = torch.zeros((1, cin, h, w), requires_grad=True)
    wt = torch.zeros((cin, cout // groups, k, k) if transposed else (cout, cin // groups, k, k),
                     requires_grad=True)
    _, ops = flops.count(lambda: _torch_conv(kind, x, wt).sum().backward())
    port_fwd = sum(o.flops for o in ops if o.name == "aten::convolution")
    port_bwd = sum(o.flops for o in ops if o.name == "aten::convolution_backward")
    assert port_fwd == fwd
    assert port_bwd == bwd == 2 * fwd
    if name == "3x3 s1":
        assert bwd == 603_979_776
    if name == "depthwise s1":
        assert bwd == 18_874_368


def test_kernel_bounds_at_the_train_cell():
    """PERF.md §6's bounds (ms, 4 places, all by bytes) of K1 at B=8,
    K=20000, D=96 and of K2-K6 on the train cell's labels (B=8, M=96, P=1024,
    512x1024); the maps the kernels read but whose bytes depend only on
    their shape are meta tensors."""
    b, m, p, h, w = torch_cases.TRAIN_SHAPE
    _, labels = bench_train_batch(b, m, h, w, edge_cases=True)
    t = generate_targets(*(torch.from_numpy(a) for a in labels), h, w, max_points=p,
                         dense_kp=False)
    tab = losses.ae_table(t, losses.coordinate_grid(h, w, torch.device("cpu")), h, w)
    cntp = ae_terms.tile_presence(t.points, t.pt_valid, h, w)
    field = torch.empty((b, h, w), device="meta")
    cnt = torch.empty((b, m, h, w), dtype=torch.uint16, device="meta")
    k1 = [torch.from_numpy(a) for a in torch_cases.affinity_inputs(*torch_cases.AFFINITY_SHAPE)]
    got = {"K1": bounds.affinity_assign(*k1),
           "K2": bounds.rasterize_cnt_r2(t.points, t.pt_valid, h, w),
           "K3": bounds.ae_terms_fwd(field, field, field, field, None, None, tab, None, cntp),
           "K4": bounds.ae_terms_bwd(field, field, field, field, None, None, tab, None, cntp),
           "K5": bounds.rasterize_nmap(t.points, t.pt_valid, t.normals, h, w),
           "K6": bounds.minr2_from_cnt(cnt, t.pt_valid.any(dim=2))}
    perf = {"K1": 0.0015, "K2": 0.3639, "K3": 0.0201, "K4": 0.0466, "K5": 0.0103, "K6": 0.1556}
    for tag, work in got.items():
        ms, by = bounds.bound(*work)
        assert (round(ms, 4), by) == (perf[tag], "bytes"), tag
    assert got["K2"].bytes == 1_219_231_744
    assert bounds.bound(got["K2"].bytes, 0)[0] == got["K2"].bytes / 3.35e9


def test_peaks_of_a_card_raise_unless_given():
    assert bounds.peaks_for("NVIDIA H100 80GB HBM3") is bounds.H100_SXM
    with pytest.raises(ValueError, match="no peak rates"):
        bounds.peaks_for("NVIDIA A100-SXM4-80GB")
    given = bounds.peaks_for("NVIDIA A100-SXM4-80GB", 2039.0, 312.0)
    assert given.bytes_per_s == 2039e9 and set(given.ops_per_s.values()) == {312e12}
    assert bounds.least_ms(3.35e9, 989e9, "bf16") == (1.0, "bytes")
    assert bounds.least_ms(0, 989e9, "bf16") == (1.0, "operations")


def _record(capsys, argv):
    roofline_tool.main(argv + ["--device", "cpu", "--compound", "0", "--hw", "128", "256",
                               "--batch", "2", "--iters", "1"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_roofline_tool_on_the_cpu(capsys, mode):
    argv = ["--eval"] if mode == "eval" else ["--max-instances", "8", "--max-points", "64",
                                              "--n-real", "4"]
    rec = _record(capsys, argv)
    args = roofline_tool.parse_args(argv + ["--device", "cpu", "--compound", "0", "--hw",
                                            "128", "256", "--batch", "2"])
    _, call = roofline_tool.build(args, torch.device("cpu"))
    call()
    _, ops = flops.count(call)
    assert rec["mode"] == mode and rec["device"] == "cpu"
    assert rec["model_flops"] == flops.total_flops(ops) > 0
    if mode == "eval":                   # the forward's convolutions, 2 frames of (a)'s B0
        assert rec["model_flops"] == 2 * 2_505_913_088
        # K1's twin, and the frozen batch norms' op (its CPU twin runs)
        assert set(rec["kernel_work"]) == {"affinity_assign", "bn_act"}
    else:                                # the twins of K2 and K5 on the CPU
        assert set(rec["kernel_work"]) == {"rasterize_cnt_r2", "rasterize_nmap"}
    for key in ("achieved_tflops", "mfu", "bound_ms", "busy_ms", "idle_share", "matched_share",
                "kernel_ms"):
        assert rec[key] is None, key
    # only operations that launch nothing go unjoined: detach, whose dispatch
    # the profiler records under another name, and the profiler's own
    assert set(rec["unjoined"]) <= {"aten::detach", "profiler::_record_function_enter_new",
                                    "profiler::_record_function_exit"}
    assert rec["calls_joined"] > 0.9 * rec["ops_counted"]


def _event(name, start, end, parent=None, **kw):
    kw.setdefault("annotation", name.startswith("block:"))
    kw.setdefault("thread", 1)
    return profiling.TraceEvent(name, start, end, parent=parent, **kw)


def test_roofline_join_of_a_trace():
    """A forward convolution in the backbone, its backward on another
    thread, an add and K2 (launched in the loss's range, outside any
    operation), a fill no count saw, and a range's device span; each
    operation the counter handled has a "PythonDispatchMode" range under
    it, each device activity a runtime launch of its correlation id."""
    device = []

    def launched(parent, kernel, start, us):
        corr = 100 + len(device)
        device.append(_event(kernel, start, start + us, device=True, id=corr))
        return _event("cudaLaunchKernel", parent.start, parent.start, parent, id=corr,
                      thread=parent.thread)

    def dispatched(name, start, end, parent, kernels, **kw):
        outer = _event(name, start, end, parent, **kw)
        mode = _event("PythonDispatchMode", start + 1, end - 1, outer, thread=outer.thread)
        inner = _event(name, start + 2, end - 2, mode, thread=outer.thread)
        return [outer, mode, inner] + [launched(inner, *k) for k in kernels]
    fwd = _event("forward", 0, 100)
    inp = _event("block:input", 1, 99, fwd)
    bb = _event("block:backbone", 2, 50, inp)
    loss = _event("loss", 100, 150)
    node = _event("autograd::engine::evaluate_function: ConvolutionBackward0", 200, 300,
                  sequence_nr=7, thread=2, fwd_thread=1)
    grad = _event("ConvolutionBackward0", 205, 295, node, scope=1, sequence_nr=7, thread=2,
                  fwd_thread=1)
    fill = _event("aten::fill_", 400, 410)
    events = [fwd, inp, bb, loss, node, grad, fill,
              *dispatched("aten::convolution", 3, 20, bb, [("sm90_conv_fprop", 5, 4.0)],
                          sequence_nr=7),
              launched(loss, "void cnt_r2_kernel<3>(int const*)", 105, 10.0),
              *dispatched("aten::add", 110, 120, loss, [("elementwise_add", 115, 2.0)]),
              *dispatched("aten::convolution_backward", 210, 290, grad,
                          [("dgrad", 215, 6.0), ("wgrad", 230, 8.0)], thread=2),
              # the gradient's accumulation, beside the node inside the engine's range
              *dispatched("aten::add", 296, 299, node, [("accumulate", 296, 0.5)], thread=2),
              launched(fill, "memset", 401, 1.0)]
    device.append(_event("block:backbone", 3, 50, device=True, annotation=True))
    events += device
    ops = [flops.OpCount("aten::convolution", 10**9, 3 * 10**6, "bf16", ""),
           flops.OpCount("aten::add", 0, 3000, None, ""),
           flops.OpCount("aten::convolution_backward", 2 * 10**9, 4 * 10**6, "bf16", ""),
           flops.OpCount("aten::add", 0, 5000, None, "")]
    work = {"rasterize_cnt_r2": [bounds.Work(335000, 0)]}
    s = profiling.roofline(events, ops, work, 1, bounds.H100_SXM)
    assert s["kernel_ms"] == pytest.approx(0.0315) and s["busy_ms"] == pytest.approx(0.0315)
    assert s["matched_ms"] == pytest.approx(0.0305) and s["calls_joined"] == 4
    want_bound = sum(bounds.least_ms(o.bytes, o.flops, o.dtype or "f32")[0] for o in ops)
    assert s["bound_ms"] == pytest.approx(want_bound + 335000 / 3.35e9)
    blocks = {r["name"]: r for r in s["by_block"]}
    assert blocks["backbone"]["ms"] == pytest.approx(0.0185)
    assert blocks["backbone"]["execs"] == 3
    assert blocks["loss"]["ms"] == pytest.approx(0.012)
    assert blocks["other"]["ms"] == pytest.approx(0.001)
    rows = {r["name"]: r for r in s["by_op"]}
    conv = rows["aten::convolution_backward "]
    assert conv["launches"] == 2 and conv["tflops"] == pytest.approx(2e9 / 0.014 / 1e9)
    assert rows["(unjoined) memset"]["bound_ms"] is None
    k2 = s["kernels"]["rasterize_cnt_r2"]
    assert (k2["tag"], k2["calls"], k2["bytes"], k2["launches"]) == ("K2", 1, [335000], 1)
    assert k2["gbps"] == pytest.approx(335000 / 0.010 / 1e6)
