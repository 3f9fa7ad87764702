"""Weights for the port: the JAX package's flax variables in both directions,
and a seeded random initialisation.

The port's state-dict keys are the reference torch keys, which
``tools/convert_torch_weights.convert_state_dict`` maps onto the flax tree;
``load_flax_variables`` is its inverse and ``export_flax_variables`` brings a
port-trained model back into the JAX package. Layouts (flax -> torch):

  * conv kernels HWIO (kh, kw, I/groups, O) -> OIHW; a depthwise kernel
    (kh, kw, 1, C) becomes (C, 1, kh, kw) by the same transpose;
  * transposed-conv kernels (kh, kw, I, O) -> (I, O, kh, kw) after flipping
    both spatial axes (flax computes a fractionally strided correlation,
    torch a true transposed convolution);
  * batch norm scale/bias -> weight/bias, batch_stats mean/var ->
    running_mean/running_var;
  * dense kernels [in, out] -> linear weights [out, in]; layer norm
    scale/bias -> weight/bias; a relative-position bias table
    ``rel_bias`` [heads, 2P - 1, 2P - 1] as it is.

A MaxViT backbone (``models/maxvit.py``, which the JAX package does not
have) takes the names of the same rules: ``backbone/stem_conv2``, and in
block N ``pre_norm``, the MBConv's convs and norms as EfficientNet's,
``shortcut_conv``, and ``{block,grid}_{attn,mlp}`` with ``norm``, ``qkv``,
``proj``, ``fc1``, ``fc2`` and the attention's ``rel_bias``.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from instance_segmentation_torch.models.bifpn import BiFPNCell
from instance_segmentation_torch.models.layers import BatchNorm
from instance_segmentation_torch.models.maxvit import RelativeAttention

# (module path pattern, flax module path) — first full match wins.
_MODULE_RULES = [
    (r"backbone_net\.model\._conv_stem\.conv", r"backbone/stem_conv/Conv_0"),
    (r"backbone_net\.model\._bn0", r"backbone/stem_bn/BatchNorm_0"),
    (r"backbone_net\.model\._conv_stem2\.conv", r"backbone/stem_conv2/Conv_0"),
    (r"backbone_net\.model\._blocks\.(\d+)\._pre_norm", r"backbone/block\1/pre_norm/BatchNorm_0"),
    (r"backbone_net\.model\._blocks\.(\d+)\.((?:block|grid)_(?:attn|mlp))\.(\w+)",
     r"backbone/block\1/\2/\3"),
    (r"backbone_net\.model\._blocks\.(\d+)\.((?:block|grid)_attn)", r"backbone/block\1/\2"),
    (r"backbone_net\.model\._blocks\.(\d+)\._se_(reduce|expand)\.conv",
     r"backbone/block\1/se/\2/Conv_0"),
    (r"backbone_net\.model\._blocks\.(\d+)\._(\w+_conv)\.conv",
     r"backbone/block\1/\2/Conv_0"),
    (r"backbone_net\.model\._blocks\.(\d+)\._(bn\d)", r"backbone/block\1/\2/BatchNorm_0"),
    (r"bifpn\.(\d+)\.(\w+)\.(depthwise|pointwise)_conv\.conv",
     r"bifpn/cell\1/\2/\3/Conv_0"),
    (r"bifpn\.(\d+)\.(\w+)\.bn", r"bifpn/cell\1/\2/bn/BatchNorm_0"),
    (r"bifpn\.(\d+)\.(\w+)\.0\.conv", r"bifpn/cell\1/\2/conv/Conv_0"),
    (r"bifpn\.(\d+)\.(\w+)\.1", r"bifpn/cell\1/\2/bn/BatchNorm_0"),
    (r"bifpn\.(\d+)", r"bifpn/cell\1"),
    (r"(regressor|classifier)\.conv_list\.(\d+)\.(depthwise|pointwise)_conv\.conv",
     r"\1/tower/conv\2/\3/Conv_0"),
    (r"(regressor|classifier)\.bn_list\.(\d+)\.(\d+)", r"\1/tower/bn_l\2_\3/BatchNorm_0"),
    (r"(regressor|classifier)\.header\.(depthwise|pointwise)_conv\.conv",
     r"\1/tower/head/\2/Conv_0"),
    (r"kp_header\.up_conv(\d+|_input)", r"kp_header/up\1/deconv"),
    (r"kp_header\.double_conv(\d+|_input)\.0", r"kp_header/double\1/conv0/Conv_0"),
    (r"kp_header\.double_conv(\d+|_input)\.1", r"kp_header/double\1/bn0/BatchNorm_0"),
    (r"kp_header\.double_conv(\d+|_input)\.3", r"kp_header/double\1/conv1/Conv_0"),
    (r"kp_header\.double_conv(\d+|_input)\.4", r"kp_header/double\1/bn1/BatchNorm_0"),
    (r"kp_header\.(kp|ae|tan)", r"kp_header/head_\1/Conv_0"),
]

_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}


def conv_kernel_from_flax(k: np.ndarray) -> np.ndarray:
    """HWIO -> OIHW."""
    return np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))


def deconv_kernel_from_flax(k: np.ndarray) -> np.ndarray:
    """flax ConvTranspose (kh, kw, I, O) -> torch ConvTranspose2d (I, O, kh, kw)."""
    return np.ascontiguousarray(np.transpose(k[::-1, ::-1], (2, 3, 0, 1)))


def conv_kernel_to_flax(k: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO."""
    return np.ascontiguousarray(np.transpose(k, (2, 3, 1, 0)))


def deconv_kernel_to_flax(k: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d (I, O, kh, kw) -> flax ConvTranspose (kh, kw, I, O)."""
    return np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1))[::-1, ::-1])


def dense_kernel_transpose(k: np.ndarray) -> np.ndarray:
    """flax Dense (in, out) <-> torch Linear (out, in): its own inverse."""
    return np.ascontiguousarray(k.T)


def _identity(a: np.ndarray) -> np.ndarray:
    return a


_INVERSE = {conv_kernel_from_flax: conv_kernel_to_flax,
            deconv_kernel_from_flax: deconv_kernel_to_flax,
            dense_kernel_transpose: dense_kernel_transpose, _identity: _identity}


def flax_leaf(key: str, module: nn.Module
              ) -> Tuple[str, Tuple[str, ...], Callable[[np.ndarray], np.ndarray]]:
    """(collection, flax path, flax->torch transform) of the port tensor
    ``key``, whose owning module is ``module``."""
    mod_path, _, leaf = key.rpartition(".")
    for pattern, repl in _MODULE_RULES:
        m = re.fullmatch(pattern, mod_path)
        if m:
            path = tuple(m.expand(repl).split("/"))
            break
    else:
        raise KeyError(f"no flax counterpart for port tensor {key!r}")
    if isinstance(module, BatchNorm):
        coll, name = _BN_LEAVES[leaf]
        return coll, path + (name,), _identity
    if isinstance(module, (BiFPNCell, RelativeAttention)):
        return "params", path + (leaf,), _identity
    if isinstance(module, nn.LayerNorm):
        return "params", path + ({"weight": "scale"}.get(leaf, leaf),), _identity
    if isinstance(module, nn.Linear):
        return "params", path + ({"weight": "kernel"}.get(leaf, leaf),), (
            dense_kernel_transpose if leaf == "weight" else _identity)
    if isinstance(module, nn.ConvTranspose2d):
        return "params", path + ({"weight": "kernel"}.get(leaf, leaf),), (
            deconv_kernel_from_flax if leaf == "weight" else _identity)
    if isinstance(module, nn.Conv2d):
        return "params", path + ({"weight": "kernel"}.get(leaf, leaf),), (
            conv_kernel_from_flax if leaf == "weight" else _identity)
    raise KeyError(f"port tensor {key!r} sits in an unmapped {type(module).__name__}")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def port_tensors_from_flax(model: nn.Module, tree: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax-shaped ``{"params": ..., "batch_stats": ...}`` tree (either
    collection may be absent; numpy or array leaves) onto the port's
    state-dict keys, in the port's layouts, as float32 CPU tensors: the
    variables themselves, or any tree shaped like them, such as JAX
    gradients. Strict: every flax leaf given must have a port tensor of the
    same shape. Keys whose flax leaf is absent are left out."""
    flat = {}
    for coll in ("params", "batch_stats"):
        flat.update({(coll,) + p: v for p, v in _flatten(tree.get(coll, {})).items()})
    modules = dict(model.named_modules())
    out, used = {}, set()
    for key, tensor in model.state_dict(keep_vars=True).items():
        coll, path, transform = flax_leaf(key, modules[key.rpartition(".")[0]])
        fkey = (coll,) + path
        if fkey not in flat:
            continue
        value = transform(flat[fkey])
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"shape mismatch for {key!r}: port {tuple(tensor.shape)}"
                             f" vs flax {'/'.join(fkey)} {tuple(value.shape)}")
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32))
        used.add(fkey)
    unused = sorted("/".join(k) for k in set(flat) - used)
    if unused:
        raise KeyError(f"{len(unused)} flax leaves have no port tensor, "
                       f"e.g. {unused[:5]}")
    return out


@torch.no_grad()
def load_flax_variables(model: nn.Module, variables: Mapping) -> int:
    """Fill every parameter and buffer of ``model`` from the JAX package's
    ``{"params", "batch_stats"}`` tree (numpy or array leaves). Strict: every
    flax leaf must be used and every port tensor set, with equal shapes.
    Returns the number of tensors set."""
    values = port_tensors_from_flax(model, variables)
    for key, tensor in model.state_dict(keep_vars=True).items():
        if key not in values:
            coll, path, _ = flax_leaf(key, dict(model.named_modules())[key.rpartition(".")[0]])
            raise KeyError(f"flax tree has no {'/'.join((coll,) + path)} for port tensor "
                           f"{key!r}")
        tensor.copy_(values[key])
    return len(values)


@torch.no_grad()
def export_flax_variables(model: nn.Module) -> Dict[str, Dict]:
    """The inverse of ``load_flax_variables``: the JAX package's
    ``{"params", "batch_stats"}`` tree of ``model``, float32 numpy leaves, so
    that a model trained in the port loads into the JAX package."""
    modules = dict(model.named_modules())
    tree: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, tensor in model.state_dict().items():
        coll, path, transform = flax_leaf(key, modules[key.rpartition(".")[0]])
        node = tree[coll]
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = _INVERSE[transform](tensor.detach().float().cpu().numpy())
    return tree


@torch.no_grad()
def init_random(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded untrained weights: conv and linear kernels ~ N(0, 1/fan_in) (the
    variance of the reference's lecun-normal init), zero biases, identity
    batch and layer norm, unit fusion weights, relative-position bias tables
    ~ N(0, 1). ``generator`` is a CPU generator; values are drawn on the CPU
    in float32, so one seed gives the same model on any device."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           / math.sqrt(m.in_features))
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, RelativeAttention):
            m.rel_bias.copy_(torch.randn(m.rel_bias.shape, generator=generator))
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            kh, kw = w.shape[2], w.shape[3]
            fan_in = (w.shape[0] if isinstance(m, nn.ConvTranspose2d)
                      else w.shape[1]) * kh * kw
            w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, BiFPNCell):
            for p in m.parameters(recurse=False):
                p.fill_(1.0)
