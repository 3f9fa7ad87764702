"""The port's AOT export (tools/export_model.py): EfficientSeg-B0 at 128x256,
batch 1, the JAX tree's seeded weights loaded through
``weights.load_flax_variables`` and saved as a port checkpoint, exported on
the CPU with and without int8, saved, loaded and run: every output equal to
the live module's (``torch.equal``, no tolerance). Also K1's custom op
through ``torch.library.opcheck`` and the program's shape: one K1 call, the
NMS loop as a ``while_loop``, no data-dependent output shape."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instance_segmentation_tpu.models import EfficientSeg as JSeg
from instance_segmentation_tpu.models import EfficientSegConfig as JCfg
from instance_segmentation_torch.kernels import affinity
from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig
from instance_segmentation_torch.ops.decode import DecodeConfig
from instance_segmentation_torch.tools import export_model
from instance_segmentation_torch.utils.checkpoint import checkpoint_name
from instance_segmentation_torch.weights import load_flax_variables

from test_torch_affinity import _inputs
from test_torch_model import random_flax_variables

torch.set_num_threads(2)
H, W = 128, 256


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    """A port checkpoint holding the JAX tree's seeded B0 weights."""
    variables = random_flax_variables(JSeg(JCfg(num_classes=8, compound_coef=0)),
                                      jnp.zeros((1, H, W, 3), jnp.uint8), train=False, seed=4)
    model = EfficientSeg(EfficientSegConfig(num_classes=8, compound_coef=0))
    load_flax_variables(model, jax.tree_util.tree_map(np.asarray, variables))
    path = tmp_path_factory.mktemp("ckpt")
    torch.save({"model": model.state_dict(), "epoch": 0, "best_ap": 0.0},
               path / checkpoint_name(0))
    return str(path)


@pytest.fixture(scope="module")
def exported(weights_dir, tmp_path_factory):
    """The float program of ``build_export``, saved and loaded back."""
    program, live, example = export_model.build_export(0, (H, W), 1, 8, weights=weights_dir)
    path = tmp_path_factory.mktemp("export") / "model.pt2"
    torch.export.save(program, str(path))
    return program, live, example, export_model.load(str(path))


def test_export_save_load_equals_live(exported):
    program, live, example, loaded = exported
    conv = live.model.kp_header.double_conv_input[0]
    assert not conv.quant and conv.weight.dtype == torch.bfloat16
    targets = [str(n.target) for n in loaded.graph.nodes if n.op == "call_function"]
    assert sum(t == "iseg.affinity_assign.default" for t in targets) == 1
    assert sum("while_loop" in t for t in targets) == 1
    assert not any(t in ("aten.nonzero.default", "aten._int_mm.default") for t in targets)
    got = export_model.verify(loaded, live, example)
    assert [tuple(t.shape) for t in got] == [(1, 96), (1, 96), (1, 96, 2), (1, 96, 1024, 2),
                                            (1, 96), (1, 96)]
    assert [t.dtype for t in got] == [torch.int32, torch.float32, torch.float32,
                                      torch.float32, torch.int32, torch.bool]


def test_value_topk_program_equals_live_decode(weights_dir, tmp_path):
    """``DecodeConfig(exact_topk=False)`` exported, saved and loaded: one
    ``topk`` over the keys in place of the bisection, and every output equal
    to the live decode's."""
    program, live, example = export_model.build_export(
        0, (H, W), 1, 8, weights=weights_dir, decode_cfg=DecodeConfig(exact_topk=False))
    assert not live.decode_cfg.exact_topk
    path = tmp_path / "approx.pt2"
    torch.export.save(program, str(path))
    loaded = export_model.load(str(path))
    targets = [str(n.target) for n in loaded.graph.nodes if n.op == "call_function"]
    assert targets.count("aten.topk.default") == 1
    assert sum(t == "iseg.affinity_assign.default" for t in targets) == 1
    export_model.verify(loaded, live, example)


def test_int8_cli_exports_and_verifies_on_the_cpu(weights_dir, tmp_path, capsys):
    out = tmp_path / "m.pt2"
    export_model.main(["--out", str(out), "--weights", weights_dir, "--compound", "0",
                       "--hw", str(H), str(W), "--quant", "int8", "--verify",
                       "--device", "cpu"])
    text = capsys.readouterr().out
    assert "verify: the loaded program matches the live model exactly" in text
    assert out.stat().st_size > 1e6


def test_verify_catches_a_different_program(exported):
    _, live, example, loaded = exported
    bias = live.model.classifier.header.pointwise_conv.conv.bias
    with torch.no_grad():
        bias.add_(1.0)
    try:
        with pytest.raises(AssertionError, match="differs"):
            export_model.verify(loaded, live, example)
    finally:
        with torch.no_grad():
            bias.sub_(1.0)


def test_affinity_custom_op_passes_opcheck():
    for seed, (b, k, d) in enumerate(((2, 300, 16), (1, 64, 1), (3, 40, 96))):
        args = tuple(torch.from_numpy(x) for x in _inputs(b, k, d, seed=seed))
        torch.library.opcheck(torch.ops.iseg.affinity_assign.default, args)
    # the wrapper is the op: equal to the plain grouping on the CPU
    args = tuple(torch.from_numpy(x) for x in _inputs(2, 300, 16, seed=9))
    got = affinity.affinity_assign(*args)
    want = affinity.affinity_assign_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
