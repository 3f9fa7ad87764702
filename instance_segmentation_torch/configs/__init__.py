"""Config layer of the port.

Counterpart of ``instance_segmentation_tpu/configs/__init__.py`` with the
same names and keys, so that the JAX package's run configs carry over:
``Config`` (attribute tree over a YAML mapping), ``Configer`` (dict-path
getter over the JSON transform config), ``StaticShapes``,
``parse_anchor_expr``, the ``load_*_config`` functions and
``static_shapes_from``. YAML is read by ``yaml_subset`` (the GPU machine
has no PyYAML); the defaults are this package's copies under ``defaults/``.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass
from typing import Any, Optional

from instance_segmentation_torch.configs import yaml_subset

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
DEFAULT_DIR = os.path.join(_PKG_DIR, "defaults")


class Config:
    """Recursive attribute view over a YAML mapping.

    Same user surface as the reference (`cfg.data.batch_size`,
    `cfg.decode_cfg_path`, ...); missing keys raise AttributeError with the
    full dotted path for debuggability.
    """

    def __init__(self, source: Any = None, _name: str = "cfg"):
        self._name = _name
        self._data: dict = {}
        if source is None:
            return
        if isinstance(source, str):
            source = yaml_subset.load_file(source) or {}
        if not isinstance(source, dict):
            raise TypeError(f"Config source must be a mapping or path, got {type(source)}")
        for k, v in source.items():
            self._data[k] = Config(v, _name=f"{_name}.{k}") if isinstance(v, dict) else v

    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        data = object.__getattribute__(self, "_data")
        if key in data:
            return data[key]
        raise AttributeError(f"missing config key: {self._name}.{key}")

    def __setattr__(self, key: str, value: Any) -> None:
        if key.startswith("_"):
            object.__setattr__(self, key, value)
        else:
            self._data[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self._data.items()
        }

    def __repr__(self) -> str:
        return f"Config({self.to_dict()})"


class Configer:
    """Dict-path getter over a JSON config (the transform-pipeline config).

    Reference surface: `Configer(configs=path).get('train_trans', 'trans_seq')`
    (configs/__init__.py:47-169). Supports get/exists/add/update/to_dict.
    """

    def __init__(self, configs: Any = None):
        if configs is None:
            self._params = {}
        elif isinstance(configs, str):
            with open(configs, "r") as f:
                self._params = json.load(f)
        elif isinstance(configs, dict):
            self._params = configs
        else:
            raise TypeError(f"Configer source must be a mapping or path, got {type(configs)}")

    def _walk(self, keys):
        node = self._params
        for k in keys:
            if not isinstance(node, dict) or k not in node:
                return None, False
            node = node[k]
        return node, True

    def exists(self, *keys: str) -> bool:
        return self._walk(keys)[1]

    def get(self, *keys: str, default: Any = None) -> Any:
        node, ok = self._walk(keys)
        return node if ok else default

    def add(self, keys, value) -> None:
        node = self._params
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if keys[-1] in node:
            raise KeyError(f"key already exists: {'.'.join(keys)}")
        node[keys[-1]] = value

    def update(self, keys, value) -> None:
        node = self._params
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value

    def to_dict(self) -> dict:
        return self._params


@dataclass(frozen=True)
class StaticShapes:
    """Static-shape budgets for the padded label/target representation.

    These replace the reference's ragged per-image python lists
    (data/__init__.py:42-52 keeps labels as lists of ragged polygon arrays):
    every label is packed into fixed-size arrays so targets, losses, and
    decode compile once and run fully on device.
    """

    max_instances: int = 96         # instances per image (Cityscapes peaks ~120; overflow truncated by area rank)
    max_vertices: int = 256         # polygon vertices per instance (decimated if exceeded)
    max_points: int = 1024          # dense boundary samples per instance (2px spacing, ref target_generator.py:259)
    pre_nms_detections: int = 512   # boxes entering NMS per image
    max_detections: int = 96        # detections kept after NMS
    max_keypoints: int = 20000      # top-K boundary peaks (decode_cfg kp_th default)
    max_points_per_object: int = 1024  # boundary points kept per decoded object


def parse_anchor_expr(value: Any):
    """Safely evaluate the reference's stringified anchor lists.

    The reference `eval()`s strings like '[2 ** 0, 2 ** (1.0 / 3.0)]'
    (train.py:249); we accept the same YAML strings but evaluate them with a
    restricted literal/arith parser instead of eval().
    """
    if not isinstance(value, str):
        return value
    node = ast.parse(value, mode="eval")

    def ev(n):
        if isinstance(n, ast.Expression):
            return ev(n.body)
        if isinstance(n, ast.Constant):
            return n.value
        if isinstance(n, (ast.List, ast.Tuple)):
            out = [ev(e) for e in n.elts]
            return tuple(out) if isinstance(n, ast.Tuple) else out
        if isinstance(n, ast.BinOp):
            a, b = ev(n.left), ev(n.right)
            if isinstance(n.op, ast.Pow):
                return a ** b
            if isinstance(n.op, ast.Mult):
                return a * b
            if isinstance(n.op, ast.Div):
                return a / b
            if isinstance(n.op, ast.Add):
                return a + b
            if isinstance(n.op, ast.Sub):
                return a - b
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.USub):
            return -ev(n.operand)
        raise ValueError(f"unsupported expression in anchor config: {ast.dump(n)}")

    return ev(node)


def load_train_config(path: Optional[str] = None) -> Config:
    cfg = Config(path or os.path.join(DEFAULT_DIR, "train_cfg.yaml"))
    if isinstance(cfg.get("optimizer") and cfg.optimizer.get("lr"), str):
        cfg.optimizer.lr = float(parse_anchor_expr(cfg.optimizer.lr))
    return cfg


def load_decode_config(path: Optional[str] = None) -> Config:
    return Config(path or os.path.join(DEFAULT_DIR, "decode_cfg.yaml"))


def load_trans_config(path: Optional[str] = None) -> Configer:
    return Configer(path or os.path.join(DEFAULT_DIR, "trans_cfg.json"))


def static_shapes_from(cfg: Config) -> StaticShapes:
    """Build StaticShapes from an optional `static:` YAML section."""
    section = cfg.get("static")
    if section is None:
        return StaticShapes()
    kwargs = {k: v for k, v in section.to_dict().items()}
    return StaticShapes(**kwargs)
