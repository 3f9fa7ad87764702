"""Weights: the flax ``{"params", "batch_stats"}`` tree that the benchmark
makes from the seed (``seeded_tree``) and hands to the port and to the
reference, and its loading into the reference model (frozen from the port's
``weights.py``). Layouts (flax -> torch):

  * conv kernels HWIO (kh, kw, I/groups, O) -> OIHW; a depthwise kernel
    (kh, kw, 1, C) becomes (C, 1, kh, kw) by the same transpose;
  * transposed-conv kernels (kh, kw, I, O) -> (I, O, kh, kw) after flipping
    both spatial axes (flax computes a fractionally strided correlation,
    torch a true transposed convolution);
  * batch norm scale/bias -> weight/bias, batch_stats mean/var ->
    running_mean/running_var.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from benchmark.reference.bifpn import BiFPNCell
from benchmark.reference.layers import BatchNorm

# (module path pattern, flax module path) — first full match wins.
_MODULE_RULES = [
    (r"backbone_net\.model\._conv_stem\.conv", r"backbone/stem_conv/Conv_0"),
    (r"backbone_net\.model\._bn0", r"backbone/stem_bn/BatchNorm_0"),
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


def _identity(a: np.ndarray) -> np.ndarray:
    return a


_INVERSE = {conv_kernel_from_flax: conv_kernel_to_flax,
            deconv_kernel_from_flax: deconv_kernel_to_flax, _identity: _identity}


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
    if isinstance(module, BiFPNCell):
        return "params", path + (leaf,), _identity
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


def flax_shapes(model: nn.Module) -> Dict[Tuple[str, ...], Tuple[Tuple[int, ...], str]]:
    """Every leaf of ``model``'s flax tree, (collection, *path) -> (its shape
    in the flax layout, its kind: "kernel", "bias", "scale", "mean", "var"
    or "fusion"), in the model's state-dict order."""
    modules = dict(model.named_modules())
    out = {}
    for key, tensor in model.state_dict().items():
        module = modules[key.rpartition(".")[0]]
        coll, path, transform = flax_leaf(key, module)
        shape = tuple(_INVERSE[transform](np.empty(tuple(tensor.shape), np.float32)).shape)
        if isinstance(module, BiFPNCell):
            kind = "fusion"
        elif isinstance(module, BatchNorm):
            kind = path[-1]
        else:
            kind = path[-1] if path[-1] in ("kernel", "bias") else "kernel"
        out[(coll,) + path] = (shape, kind)
    return out


@torch.no_grad()
def seeded_tree(model: nn.Module, seed: int, device: torch.device) -> Dict[str, Dict]:
    """Seeded untrained weights as a flax ``{"params", "batch_stats"}`` tree
    of float32 numpy leaves, for every leaf of ``model`` (any module with the
    port's structure): conv kernels ~ N(0, 1/fan_in) (the reference's
    lecun-normal variance; fan_in = kh * kw * I in the flax layout), zero
    biases, identity batch norm, unit fusion weights. The kernels are drawn
    in one call on ``device`` from a generator seeded with ``seed`` and
    copied to the host once."""
    shapes = flax_shapes(model)
    kernels = [(k, s) for k, (s, kind) in shapes.items() if kind == "kernel"]
    total = sum(int(np.prod(s)) for _, s in kernels)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    scales = [torch.full((int(np.prod(s)),), 1.0 / math.sqrt(int(np.prod(s[:-1]))),
                         device=device) for _, s in kernels]
    flat = (flat * torch.cat(scales)).cpu().numpy()
    tree: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    fill = {"bias": 0.0, "scale": 1.0, "mean": 0.0, "var": 1.0, "fusion": 1.0}
    offset = 0
    drawn = dict(kernels)
    for key, (shape, kind) in shapes.items():
        if key in drawn:
            n = int(np.prod(shape))
            value = flat[offset:offset + n].reshape(shape)
            offset += n
        else:
            value = np.full(shape, fill[kind], np.float32)
        node = tree[key[0]]
        for name in key[1:-1]:
            node = node.setdefault(name, {})
        node[key[-1]] = value
    return tree
