"""The flax-style weight tree of EfficientSeg on a MaxViT backbone
(``efficientseg_maxvit.py``): the rules of ``weights.py`` for every module
the B-series model has, and these for MaxViT's own (the port's
``weights.py`` names them alike):

  * ``backbone/stem_conv2``, and in block N ``pre_norm`` (a batch norm),
    ``shortcut_conv`` and the MBConv's convs and norms under EfficientNet's
    names;
  * ``backbone/blockN/{block,grid}_{attn,mlp}/{norm,qkv,proj,fc1,fc2}``:
    dense kernels [in, out] (torch [out, in]), layer-norm ``scale`` and
    ``bias``; and the attention's ``rel_bias`` table [heads, 2P - 1, 2P - 1].

``seeded_tree`` draws the seeded untrained weights of ``weights.py`` (conv
and dense kernels N(0, 1/fan_in), zero biases, identity batch and layer
norm, unit fusion weights) and the bias tables N(0, 1): trained tables are
of order one, and MaxViT's own initialisation (std 0.02) would leave the
bias all but unseen in the heads. ``load_flax_variables`` fills a model from
such a tree, strictly, as ``weights.py``'s does.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from benchmark.reference import weights
from benchmark.reference.bifpn import BiFPNCell
from benchmark.reference.layers import BatchNorm
from benchmark.reference.maxvit import RelativeAttention

_MODULE_RULES = [
    (r"backbone_net\.model\._conv_stem2\.conv", r"backbone/stem_conv2/Conv_0"),
    (r"backbone_net\.model\._blocks\.(\d+)\._pre_norm", r"backbone/block\1/pre_norm/BatchNorm_0"),
    (r"backbone_net\.model\._blocks\.(\d+)\.((?:block|grid)_(?:attn|mlp))\.(\w+)",
     r"backbone/block\1/\2/\3"),
    (r"backbone_net\.model\._blocks\.(\d+)\.((?:block|grid)_attn)", r"backbone/block\1/\2"),
]


def dense_kernel_transpose(k: np.ndarray) -> np.ndarray:
    """flax Dense (in, out) <-> torch Linear (out, in): its own inverse."""
    return np.ascontiguousarray(k.T)


_INVERSE = {**weights._INVERSE, dense_kernel_transpose: dense_kernel_transpose}


def flax_leaf(key: str, module: nn.Module
              ) -> Tuple[str, Tuple[str, ...], Callable[[np.ndarray], np.ndarray]]:
    """(collection, flax path, flax->torch transform) of the model tensor
    ``key``, whose owning module is ``module``."""
    mod_path, _, leaf = key.rpartition(".")
    for pattern, repl in _MODULE_RULES:
        m = re.fullmatch(pattern, mod_path)
        if m:
            path = tuple(m.expand(repl).split("/"))
            break
    else:
        return weights.flax_leaf(key, module)
    if isinstance(module, BatchNorm):
        coll, name = weights._BN_LEAVES[leaf]
        return coll, path + (name,), weights._identity
    if isinstance(module, RelativeAttention):
        return "params", path + (leaf,), weights._identity
    if isinstance(module, nn.LayerNorm):
        return "params", path + ({"weight": "scale"}.get(leaf, leaf),), weights._identity
    if isinstance(module, nn.Linear):
        return "params", path + ({"weight": "kernel"}.get(leaf, leaf),), (
            dense_kernel_transpose if leaf == "weight" else weights._identity)
    if isinstance(module, nn.Conv2d):
        return "params", path + ({"weight": "kernel"}.get(leaf, leaf),), (
            weights.conv_kernel_from_flax if leaf == "weight" else weights._identity)
    raise KeyError(f"model tensor {key!r} sits in an unmapped {type(module).__name__}")


def flax_shapes(model: nn.Module) -> Dict[Tuple[str, ...], Tuple[Tuple[int, ...], str]]:
    """Every leaf of ``model``'s tree, (collection, *path) -> (its shape in
    the flax layout, its kind: "kernel", "table", "bias", "scale", "mean",
    "var" or "fusion"), in the model's state-dict order."""
    modules = dict(model.named_modules())
    out = {}
    for key, tensor in model.state_dict().items():
        module = modules[key.rpartition(".")[0]]
        coll, path, transform = flax_leaf(key, module)
        shape = tuple(_INVERSE[transform](np.empty(tuple(tensor.shape), np.float32)).shape)
        if isinstance(module, BiFPNCell):
            kind = "fusion"
        elif isinstance(module, RelativeAttention):
            kind = "table"
        elif isinstance(module, (BatchNorm, nn.LayerNorm)):
            kind = path[-1]
        else:
            kind = path[-1] if path[-1] in ("kernel", "bias") else "kernel"
        out[(coll,) + path] = (shape, kind)
    return out


@torch.no_grad()
def seeded_tree(model: nn.Module, seed: int, device: torch.device) -> Dict[str, Dict]:
    """The seeded tree of ``model`` (see the module docstring), float32 numpy
    leaves: the kernels and tables drawn in one call on ``device`` from a
    generator seeded with ``seed``, in state-dict order, and copied to the
    host once."""
    shapes = flax_shapes(model)
    drawn = [(k, s, kind) for k, (s, kind) in shapes.items() if kind in ("kernel", "table")]
    sizes = [int(np.prod(s)) for _, s, _ in drawn]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    scales = [torch.full((n,), 1.0 if kind == "table" else float(np.prod(s[:-1])) ** -0.5,
                         device=device) for n, (_, s, kind) in zip(sizes, drawn)]
    flat = (flat * torch.cat(scales)).cpu().numpy()
    fill = {"bias": 0.0, "scale": 1.0, "mean": 0.0, "var": 1.0, "fusion": 1.0}
    values, offset = {}, 0
    for (key, shape, _), n in zip(drawn, sizes):
        values[key] = flat[offset:offset + n].reshape(shape)
        offset += n
    tree: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, (shape, kind) in shapes.items():
        value = values[key] if key in values else np.full(shape, fill[kind], np.float32)
        node = tree[key[0]]
        for name in key[1:-1]:
            node = node.setdefault(name, {})
        node[key[-1]] = value
    return tree


@torch.no_grad()
def load_flax_variables(model: nn.Module, variables: Mapping) -> int:
    """Fill every parameter and buffer of ``model`` from the tree. Strict:
    every leaf used and every tensor set, with equal shapes. Returns the
    number of tensors set."""
    flat = {}
    for coll in ("params", "batch_stats"):
        flat.update({(coll,) + p: v for p, v in weights._flatten(variables.get(coll, {})).items()})
    modules = dict(model.named_modules())
    used = set()
    for key, tensor in model.state_dict(keep_vars=True).items():
        coll, path, transform = flax_leaf(key, modules[key.rpartition(".")[0]])
        fkey = (coll,) + path
        if fkey not in flat:
            raise KeyError(f"the tree has no {'/'.join(fkey)} for tensor {key!r}")
        value = transform(flat[fkey])
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"shape mismatch for {key!r}: {tuple(tensor.shape)} vs "
                             f"{'/'.join(fkey)} {tuple(value.shape)}")
        tensor.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
        used.add(fkey)
    unused = sorted("/".join(k) for k in set(flat) - used)
    if unused:
        raise KeyError(f"{len(unused)} tree leaves have no tensor, e.g. {unused[:5]}")
    return len(used)
