"""compound_coef 8 (the P8 level of the pyramid) against the JAX package on
the CPU: the BiFPN with ``use_p8`` at narrow widths (16 channels, 2
repeats, fast-attention and plain-sum fusion), its seeded weights carried
by the weight bridge, to 2e-4 (the model tests' tolerance), with the P8
layer names those of the reference converters; the coef-8 EfficientSeg's
variable tree (``jax.eval_shape``, nothing compiled) covered leaf for leaf
and shape for shape by the bridge; the anchors of coef 8's six levels at
1536x1536 equal to the JAX copy's; and the coef-8 forward's output shapes
at 1536x1536 (the port's on the meta device) equal to ``jax.eval_shape``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instance_segmentation_tpu.models import bifpn as jbifpn
from instance_segmentation_tpu.models import efficientseg as jseg
from instance_segmentation_tpu.models.anchors import generate_anchors as j_generate_anchors
from instance_segmentation_torch.models import bifpn as tbifpn
from instance_segmentation_torch.models import efficientseg as tseg
from instance_segmentation_torch.models.anchors import generate_anchors
from instance_segmentation_torch.utils.convert_torch_weights import convert_state_dict
from instance_segmentation_torch.weights import (
    conv_kernel_from_flax, deconv_kernel_from_flax, export_flax_variables, flax_leaf,
    load_flax_variables,
)

from test_torch_model import TOL, _Holder, nchw, nhwc, random_flax_variables

torch.set_num_threads(2)
SIZE = jseg.INPUT_SIZES[8]
P8_NAMES = ("conv7_up", "conv8_down", "p7_w1", "p8_w2")


@pytest.mark.parametrize("attention", [True, False], ids=["fast_attention", "sum"])
def test_bifpn_with_p8_matches_flax(attention):
    rng = np.random.default_rng(7)
    conv_channels = (8, 12, 16)
    feats = [rng.normal(size=(2, 64 // 2 ** i, 64 // 2 ** i, c)).astype(np.float32)
             for i, c in enumerate(conv_channels)]
    jm = jbifpn.BiFPN(num_channels=16, conv_channels=conv_channels, repeats=2,
                      attention=attention, use_p8=True)
    v = random_flax_variables(jm, [jnp.asarray(f) for f in feats], seed=8)
    want = jm.apply(v, [jnp.asarray(f) for f in feats])
    holder = _Holder(bifpn=tbifpn.BiFPN(16, conv_channels, 2, attention=attention,
                                        use_p8=True))
    tree = {"params": {"bifpn": v["params"]}, "batch_stats": {"bifpn": v["batch_stats"]}}
    n = load_flax_variables(holder, tree)
    assert n == len(holder.state_dict()) == len(jax.tree_util.tree_leaves(v))
    with torch.no_grad():
        got = holder.bifpn([nchw(f) for f in feats])
    assert len(got) == len(want) == 6
    assert [g.shape[-1] for g in got] == [64, 32, 16, 8, 4, 2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), **TOL)
    keys = set(holder.state_dict())
    for name in P8_NAMES[:2] if not attention else P8_NAMES:
        assert any(f".{name}" in k for k in keys), name
    # both directions of the bridge, and the reference converter's names
    back = export_flax_variables(holder)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    zeroed = jax.tree.map(np.zeros_like, tree)
    converted, count = convert_state_dict(
        {k: t.numpy() for k, t in holder.state_dict().items()}, zeroed, 8)
    assert count == n
    for (path, leaf), (_, conv) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                       jax.tree_util.tree_flatten_with_path(converted)[0]):
        np.testing.assert_array_equal(np.asarray(conv), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


_PERM = {conv_kernel_from_flax: (3, 2, 0, 1), deconv_kernel_from_flax: (2, 3, 0, 1)}


@pytest.fixture(scope="module")
def coef8():
    jm = jseg.EfficientSeg(jseg.EfficientSegConfig(num_classes=80, compound_coef=8))
    x = jnp.zeros((1, SIZE, SIZE, 3), jnp.uint8)
    outs, shapes = jax.eval_shape(lambda r: jm.init_with_output({"params": r}, x, train=False),
                                  jax.random.PRNGKey(0))
    with torch.device("meta"):
        port = tseg.EfficientSeg(tseg.EfficientSegConfig(num_classes=80, compound_coef=8))
    return shapes, outs, port


def test_coef8_variables_covered_by_the_bridge(coef8):
    shapes, _, port = coef8
    flat = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes[coll])[0]:
            flat[(coll,) + tuple(p.key for p in path)] = tuple(leaf.shape)
    modules = dict(port.named_modules())
    used = set()
    for key, tensor in port.state_dict().items():
        coll, path, transform = flax_leaf(key, modules[key.rpartition(".")[0]])
        fkey = (coll,) + path
        assert fkey in flat, (key, fkey)
        perm = _PERM.get(transform)
        want = tuple(flat[fkey][i] for i in perm) if perm else flat[fkey]
        assert tuple(tensor.shape) == want, key
        used.add(fkey)
    assert used == set(flat)
    cell = shapes["params"]["bifpn"]["cell0"]
    assert "conv7_up" in cell and "conv8_down" in cell and "p7_w1" not in cell   # plain sums
    assert len(port.bifpn) == jseg.FPN_REPEATS[8] and port.bifpn[0].use_p8


def test_coef8_anchors_and_forward_shapes(coef8):
    _, outs, port = coef8
    cfg = port.cfg
    assert cfg.pyramid_levels == (3, 4, 5, 6, 7, 8) and cfg.anchor_scale == 4.0
    got = generate_anchors(SIZE, SIZE, pyramid_levels=cfg.pyramid_levels,
                           anchor_scale=cfg.anchor_scale)
    want = j_generate_anchors(SIZE, SIZE, pyramid_levels=cfg.pyramid_levels,
                              anchor_scale=cfg.anchor_scale)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert tseg.INPUT_SIZES == jseg.INPUT_SIZES
    with torch.no_grad():
        got = port(torch.zeros(1, SIZE, SIZE, 3, dtype=torch.uint8, device="meta"))
    assert [tuple(g.shape) for g in got] == [tuple(o.shape) for o in outs]
    assert got[3].shape[1] == got[4].shape[1] == len(want)
    with pytest.raises(ValueError, match="0..8"):
        tseg.EfficientSegConfig(compound_coef=9)
