"""Whole-model parity beyond B0: EfficientSeg at compound coefs 1-8 in
float32, the port against flax on one seeded frame (coefs 1-7 at 128x256,
coef 8 at 256x256: its P8 level needs the larger side), with variables from
``random_flax_variables`` loaded through ``load_flax_variables``. All five
eval outputs within the model tests' 2e-4 (tests/test_torch_model.py holds
B0 the same way, stage by stage)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instance_segmentation_tpu.models import efficientseg as jseg
from instance_segmentation_torch.models import efficientseg as tseg
from instance_segmentation_torch.weights import load_flax_variables

from test_torch_model import random_flax_variables

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)
OUTPUTS = ("kp", "ae", "tan", "regression", "classification")


def hw_of(coef: int):
    return (256, 256) if coef == 8 else (128, 256)


def assert_coef_matches_flax(coef: int) -> None:
    h, w = hw_of(coef)
    images = np.random.default_rng(coef).integers(0, 256, (1, h, w, 3), dtype=np.uint8)
    jmodel = jseg.EfficientSeg(jseg.EfficientSegConfig(num_classes=8, compound_coef=coef))
    variables = random_flax_variables(jmodel, jnp.asarray(images), train=False, seed=20 + coef)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False, packed_heads=False))(
        variables, jnp.asarray(images))
    port = tseg.EfficientSeg(tseg.EfficientSegConfig(num_classes=8, compound_coef=coef))
    load_flax_variables(port, jax.tree_util.tree_map(np.asarray, variables))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(images))
    assert len(got) == len(want) == 5
    for name, g, wnt in zip(OUTPUTS, got, want):
        wnt = np.asarray(wnt)
        assert g.dtype == torch.float32 and tuple(g.shape) == wnt.shape, name
        np.testing.assert_allclose(g.numpy(), wnt, err_msg=f"coef {coef} {name}", **TOL)


@pytest.mark.parametrize("coef", [1, 2, 3, 4])
def test_coef_outputs_match_flax(coef):
    assert_coef_matches_flax(coef)
