"""Map the reference's PyTorch EfficientSeg ``state_dict`` onto the JAX
package's ``{"params", "batch_stats"}`` tree, without JAX.

A numpy-only copy of ``convert_state_dict`` and its helpers from the JAX
package's ``tools/convert_torch_weights.py`` (there, ``jax.tree.map``
copies the template tree; here ``_copy_tree`` does). The port's own
``state_dict`` uses the reference's names and layouts, so it converts the
same way. ``tests/test_torch_trainer.py`` holds the copy equal to the
original.

Layout notes (as there):
  * torch conv weights are OIHW -> flax HWIO (transpose 2,3,1,0); depthwise
    convs keep the same transpose (torch (C,1,kh,kw) -> flax (kh,kw,1,C));
  * torch ConvTranspose2d weights (I,O,kh,kw) -> (kh,kw,I,O) with the
    spatial dims flipped;
  * running_mean/var map to the batch_stats mean/var.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np


def _copy_tree(tree: Mapping) -> Dict:
    """The dict structure of ``tree`` copied, its leaves as numpy arrays."""
    return {k: _copy_tree(v) if isinstance(v, Mapping) else np.asarray(v)
            for k, v in tree.items()}


def _conv(w) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


def _deconv(w) -> np.ndarray:
    w = np.transpose(np.asarray(w), (2, 3, 0, 1))      # (kh, kw, I, O)
    return np.ascontiguousarray(w[::-1, ::-1])


def _set(tree: Dict, path: Tuple[str, ...], value: np.ndarray, strict: bool):
    node = tree
    for k in path[:-1]:
        if k not in node:
            if strict:
                raise KeyError(f"missing path {'/'.join(path)}")
            return False
        node = node[k]
    leaf = path[-1]
    if leaf not in node:
        if strict:
            raise KeyError(f"missing leaf {'/'.join(path)}")
        return False
    if tuple(node[leaf].shape) != tuple(value.shape):
        raise ValueError(f"shape mismatch at {'/'.join(path)}: "
                         f"{node[leaf].shape} vs {value.shape}")
    node[leaf] = value.astype(np.asarray(node[leaf]).dtype)
    return True


def _bn_entries(params: Dict, stats: Dict, flax_prefix: Tuple[str, ...],
                torch_prefix: str, sd: Dict, strict: bool) -> int:
    n = 0
    pairs = [("weight", params, "scale"), ("bias", params, "bias"),
             ("running_mean", stats, "mean"), ("running_var", stats, "var")]
    for t_leaf, tree, f_leaf in pairs:
        key = f"{torch_prefix}.{t_leaf}"
        if key in sd:
            n += _set(tree, flax_prefix + ("BatchNorm_0", f_leaf),
                      np.asarray(sd[key]), strict)
    return n


def _sep_conv(params: Dict, stats: Dict, fp: Tuple[str, ...], tp: str,
              sd: Dict, strict: bool, norm: bool = True) -> int:
    """SeparableConvBlock: depthwise (no bias) + pointwise (+BN)."""
    n = 0
    if f"{tp}.depthwise_conv.conv.weight" in sd:
        n += _set(params, fp + ("depthwise", "Conv_0", "kernel"),
                  _conv(sd[f"{tp}.depthwise_conv.conv.weight"]), strict)
        n += _set(params, fp + ("pointwise", "Conv_0", "kernel"),
                  _conv(sd[f"{tp}.pointwise_conv.conv.weight"]), strict)
        n += _set(params, fp + ("pointwise", "Conv_0", "bias"),
                  np.asarray(sd[f"{tp}.pointwise_conv.conv.bias"]), strict)
    if norm:
        n += _bn_entries(params, stats, fp + ("bn",), f"{tp}.bn", sd, strict)
    return n


def convert_state_dict(sd: Dict[str, Any], variables: Dict, compound_coef: int,
                       strict: bool = False) -> Tuple[Dict, int]:
    """Fill a flax variables dict {params, batch_stats} from a torch sd.

    Returns (variables, number of tensors loaded). Unknown/missing keys are
    skipped unless strict (mirroring the reference's non-strict resume,
    ref train.py:129,141).
    """
    sd = {k: v for k, v in sd.items()}
    params = _copy_tree(variables["params"])
    stats = _copy_tree(variables.get("batch_stats", {}))
    n = 0

    # ---- backbone ----------------------------------------------------------
    bb = "backbone_net.model"
    if f"{bb}._conv_stem.conv.weight" in sd:
        n += _set(params, ("backbone", "stem_conv", "Conv_0", "kernel"),
                  _conv(sd[f"{bb}._conv_stem.conv.weight"]), strict)
    n += _bn_entries(params, stats, ("backbone", "stem_bn"), f"{bb}._bn0", sd, strict)

    block_ids = sorted({int(m.group(1)) for k in sd
                        for m in [re.match(rf"{re.escape(bb)}\._blocks\.(\d+)\.", k)] if m})
    for i in block_ids:
        t = f"{bb}._blocks.{i}"
        f = ("backbone", f"block{i}")
        if f"{t}._expand_conv.conv.weight" in sd:
            n += _set(params, f + ("expand_conv", "Conv_0", "kernel"),
                      _conv(sd[f"{t}._expand_conv.conv.weight"]), strict)
            n += _bn_entries(params, stats, f + ("bn0",), f"{t}._bn0", sd, strict)
        n += _set(params, f + ("depthwise_conv", "Conv_0", "kernel"),
                  _conv(sd[f"{t}._depthwise_conv.conv.weight"]), strict)
        n += _bn_entries(params, stats, f + ("bn1",), f"{t}._bn1", sd, strict)
        if f"{t}._se_reduce.conv.weight" in sd:
            for se_t, se_f in [("_se_reduce", "reduce"), ("_se_expand", "expand")]:
                n += _set(params, f + ("se", se_f, "Conv_0", "kernel"),
                          _conv(sd[f"{t}.{se_t}.conv.weight"]), strict)
                n += _set(params, f + ("se", se_f, "Conv_0", "bias"),
                          np.asarray(sd[f"{t}.{se_t}.conv.bias"]), strict)
        n += _set(params, f + ("project_conv", "Conv_0", "kernel"),
                  _conv(sd[f"{t}._project_conv.conv.weight"]), strict)
        n += _bn_entries(params, stats, f + ("bn2",), f"{t}._bn2", sd, strict)

    # ---- BiFPN -------------------------------------------------------------
    cell_ids = sorted({int(m.group(1)) for k in sd
                       for m in [re.match(r"bifpn\.(\d+)\.", k)] if m})
    for c in cell_ids:
        t = f"bifpn.{c}"
        f = ("bifpn", f"cell{c}")
        for name in ["conv3_up", "conv4_up", "conv5_up", "conv6_up", "conv7_up",
                     "conv4_down", "conv5_down", "conv6_down", "conv7_down",
                     "conv8_down"]:
            n += _sep_conv(params, stats, f + (name,), f"{t}.{name}", sd, strict)
        for name in ["p3_down_channel", "p4_down_channel", "p5_down_channel",
                     "p4_down_channel_2", "p5_down_channel_2"]:
            if f"{t}.{name}.0.conv.weight" in sd:
                n += _set(params, f + (name, "conv", "Conv_0", "kernel"),
                          _conv(sd[f"{t}.{name}.0.conv.weight"]), strict)
                n += _set(params, f + (name, "conv", "Conv_0", "bias"),
                          np.asarray(sd[f"{t}.{name}.0.conv.bias"]), strict)
                n += _bn_entries(params, stats, f + (name, "bn"), f"{t}.{name}.1", sd, strict)
        if f"{t}.p5_to_p6.0.conv.weight" in sd:
            n += _set(params, f + ("p5_to_p6", "conv", "Conv_0", "kernel"),
                      _conv(sd[f"{t}.p5_to_p6.0.conv.weight"]), strict)
            n += _set(params, f + ("p5_to_p6", "conv", "Conv_0", "bias"),
                      np.asarray(sd[f"{t}.p5_to_p6.0.conv.bias"]), strict)
            n += _bn_entries(params, stats, f + ("p5_to_p6", "bn"), f"{t}.p5_to_p6.1", sd, strict)
        for wname in ["p3_w1", "p4_w1", "p5_w1", "p6_w1", "p7_w1",
                      "p4_w2", "p5_w2", "p6_w2", "p7_w2", "p8_w2"]:
            if f"{t}.{wname}" in sd:
                n += _set(params, f + (wname,), np.asarray(sd[f"{t}.{wname}"]), strict)

    # ---- box towers --------------------------------------------------------
    for tower, fname in [("regressor", "regressor"), ("classifier", "classifier")]:
        conv_ids = sorted({int(m.group(1)) for k in sd
                           for m in [re.match(rf"{tower}\.conv_list\.(\d+)\.", k)] if m})
        for i in conv_ids:
            n += _sep_conv(params, stats, (fname, "tower", f"conv{i}"),
                           f"{tower}.conv_list.{i}", sd, strict, norm=False)
        bn_keys = [k for k in sd if re.match(rf"{tower}\.bn_list\.\d+\.\d+\.weight$", k)]
        for k in bn_keys:
            m = re.match(rf"{tower}\.bn_list\.(\d+)\.(\d+)\.weight$", k)
            li, i = int(m.group(1)), int(m.group(2))
            n += _bn_entries(params, stats, (fname, "tower", f"bn_l{li}_{i}"),
                             f"{tower}.bn_list.{li}.{i}", sd, strict)
        n += _sep_conv(params, stats, (fname, "tower", "head"),
                       f"{tower}.header", sd, strict, norm=False)

    # ---- U-Net decoder -----------------------------------------------------
    for i in range(1, 5):
        t = f"kp_header.up_conv{i}"
        if f"{t}.weight" in sd:
            n += _set(params, ("kp_header", f"up{i}", "deconv", "kernel"),
                      _deconv(sd[f"{t}.weight"]), strict)
            n += _set(params, ("kp_header", f"up{i}", "deconv", "bias"),
                      np.asarray(sd[f"{t}.bias"]), strict)
        t = f"kp_header.double_conv{i}"
        for j, (ci, bi) in enumerate([(0, 1), (3, 4)]):
            if f"{t}.{ci}.weight" in sd:
                n += _set(params, ("kp_header", f"double{i}", f"conv{j}", "Conv_0", "kernel"),
                          _conv(sd[f"{t}.{ci}.weight"]), strict)
                n += _set(params, ("kp_header", f"double{i}", f"conv{j}", "Conv_0", "bias"),
                          np.asarray(sd[f"{t}.{ci}.bias"]), strict)
                n += _bn_entries(params, stats, ("kp_header", f"double{i}", f"bn{j}"),
                                 f"{t}.{bi}", sd, strict)
    if "kp_header.up_conv_input.weight" in sd:
        n += _set(params, ("kp_header", "up_input", "deconv", "kernel"),
                  _deconv(sd["kp_header.up_conv_input.weight"]), strict)
        n += _set(params, ("kp_header", "up_input", "deconv", "bias"),
                  np.asarray(sd["kp_header.up_conv_input.bias"]), strict)
        for j, (ci, bi) in enumerate([(0, 1), (3, 4)]):
            n += _set(params, ("kp_header", "double_input", f"conv{j}", "Conv_0", "kernel"),
                      _conv(sd[f"kp_header.double_conv_input.{ci}.weight"]), strict)
            n += _set(params, ("kp_header", "double_input", f"conv{j}", "Conv_0", "bias"),
                      np.asarray(sd[f"kp_header.double_conv_input.{ci}.bias"]), strict)
            n += _bn_entries(params, stats, ("kp_header", "double_input", f"bn{j}"),
                             f"kp_header.double_conv_input.{bi}", sd, strict)
    for head in ["kp", "ae", "tan"]:
        if f"kp_header.{head}.weight" in sd:
            n += _set(params, ("kp_header", f"head_{head}", "Conv_0", "kernel"),
                      _conv(sd[f"kp_header.{head}.weight"]), strict)
            n += _set(params, ("kp_header", f"head_{head}", "Conv_0", "bias"),
                      np.asarray(sd[f"kp_header.{head}.bias"]), strict)

    return {"params": params, "batch_stats": stats}, n
