"""The port's config layer against the JAX package's: the YAML-subset reader
(``configs/yaml_subset.py``) equals ``yaml.safe_load`` on every ``.yaml`` in
the repository, on the configs ``tests/test_cli.py`` dumps (and the same
configs as the card tests write them without PyYAML) and on PyYAML's
float rule (``1e-4`` is a string, ``1.0e-4`` a float), and raises outside its
subset; the port's default files parse to what the originals parse to; and
``Config``, ``Configer``, ``StaticShapes``, ``static_shapes_from`` and
``parse_anchor_expr`` equal the JAX ones."""

import glob
import json
import math
import os

import pytest
import yaml

from instance_segmentation_tpu import configs as jc
from instance_segmentation_torch import configs as tc
from instance_segmentation_torch.configs import yaml_subset

from torch_cases import yaml_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_YAML = sorted(
    os.path.relpath(p, REPO) for p in glob.glob(os.path.join(REPO, "**", "*.yaml"),
                                                recursive=True)
    if not os.path.relpath(p, REPO).startswith(("build", "chiprun_out", "datasets")))

# the configs tests/test_cli.py writes with yaml.safe_dump
CLI_CONFIGS = {
    "decode": {"cls_th": 0.3, "iou_th": 0.2, "kp_th": 2000, "obj_pixel_th": 2,
               "wh_delta": 0.1, "alpha_ratio": 2, "draw_flag": False},
    "test": {"data": {"test_dir": "/data/leftImg8bit/val", "test_image": None,
                      "save_dir": "/out/test_out", "dataset": "dir", "batch_size": 1,
                      "input_size": [128, 256], "num_classes": 8},
             "seed": 1, "compound_coef": 0, "weights_path": None,
             "decode_cfg_path": "/cfg/decode.yaml", "trans_cfg_path": "/cfg/trans.json"},
    "train": {"data": {"train_dir": "/data", "save_dir": "/out/ckpt", "dataset": "cityscapes",
                       "batch_size": 2, "num_classes": -1},
              "optimizer": {"lr": 1e-4, "type": "Adam", "momentum": 0.9},
              "max_iter": 1, "num_epochs": 1, "save_span": 1000, "seed": 1,
              "compound_coef": 0,
              "anchors_scales": "[2 ** 0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0)]",
              "anchors_ratios": "[(1.0, 1.0), (1.4, 0.7), (0.7, 1.4)]",
              "pretrained_path": None, "start_eval_epoch": 10 ** 9,
              "decode_cfg_path": "/cfg/decode.yaml", "trans_cfg_path": "/cfg/trans.json",
              "tpu": {"compute_dtype": "float32", "input_size": [128, 256]},
              "static": {"max_instances": 8, "max_vertices": 16, "max_points": 128}},
    "eval": {"data": {"eval_dir": "/data", "save_dir": "/out/eval_out",
                      "dataset": "cityscapes", "batch_size": 2, "input_size": [128, 256],
                      "num_classes": -1, "subset": "val"},
             "seed": 1, "compound_coef": 0, "weights_path": None, "weights_dir": None,
             "decode_cfg_path": "/cfg/decode.yaml", "trans_cfg_path": "/cfg/trans.json",
             "tpu": {"compute_dtype": "float32", "input_size": [128, 256]},
             "static": {"max_instances": 8, "max_vertices": 16, "max_points": 128}},
}

SUBSET_DOCS = [
    "lr: 1e-4\nlr2: 1.0e-4\nlr3: 1.0e4\nhalf: .5\nneg: -0.25\nplus: +3\nhex: 0x1F\n"
    "octal: 017\nbin: 0b101\nsep: 1_000\ninf: .inf\nninf: -.Inf\n",
    "a: yes\nb: No\nc: on\nd: OFF\ne: y\nf: n\ng: ~\nh: null\ni:\nj: 'it''s'\n"
    "k: \"a\\tb\\u00e9\"\nl: it's\nm: a 'b # c\n",
    "x:\n- 1\n- [2, -3]\n- 'q'\ny:\n  - a\n  - b\nz: []\nw: {}\nv: [[1, 2], [3, [4]], []]\n",
    "outer:\n  inner:\n    deep: 3   # comment\n      # more\n  other: 'x # not comment'\n"
    "# top comment\nlast: \"#q\"\n",
    "s: [(1.0, 1.0)]\npath: /a/b.yaml\nurl: http://x\n",
    "",
]

OUTSIDE = ["k: -\n", "k: &a 1\n", "k: *a\n", "k: !!str 1\n", "k: |\n  text\n", "k: >\n  t\n",
           "k: {a: 1}\n", "- a: 1\n", "k: 1:30\n", "---\nk: 1\n", "k: a: b\n",
           "k: 'open\n  more'\n", "k:\n\t- 1\n"]


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _texts():
    out = [(p, open(os.path.join(REPO, p)).read()) for p in REPO_YAML]
    out += [(f"test_cli {k}", yaml.safe_dump(v)) for k, v in CLI_CONFIGS.items()]
    out += [(f"yaml_text {k}", yaml_text(v)) for k, v in CLI_CONFIGS.items()]
    out += [(f"subset {i}", d) for i, d in enumerate(SUBSET_DOCS)]
    return out


@pytest.mark.parametrize("name,text", _texts(), ids=[n for n, _ in _texts()])
def test_yaml_subset_equals_safe_load(name, text):
    assert _same(yaml_subset.load(text), yaml.safe_load(text)), name


def test_pyyaml_float_rule():
    got = yaml_subset.load("a: 1e-4\nb: 1.0e-4\n")
    assert got == {"a": "1e-4", "b": 1.0e-4} == yaml.safe_load("a: 1e-4\nb: 1.0e-4\n")


@pytest.mark.parametrize("text", OUTSIDE)
def test_yaml_subset_raises_outside_the_subset(text):
    with pytest.raises(yaml_subset.YamlSubsetError):
        yaml_subset.load(text)


def test_default_copies_parse_as_the_originals():
    jdir, tdir = jc.DEFAULT_DIR, tc.DEFAULT_DIR
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    for n in names:
        if n.endswith(".json"):
            assert json.load(open(os.path.join(tdir, n))) == json.load(open(os.path.join(jdir, n)))
        else:
            assert _same(yaml_subset.load_file(os.path.join(tdir, n)),
                         yaml.safe_load(open(os.path.join(jdir, n)))), n


def test_config_and_loaders_equal_jax(tmp_path):
    for name, cfg in CLI_CONFIGS.items():
        p = tmp_path / f"{name}.yaml"
        p.write_text(yaml.safe_dump(cfg))
        assert tc.Config(str(p)).to_dict() == jc.Config(str(p)).to_dict()
    t = tc.Config(str(tmp_path / "eval.yaml"))
    assert t.data.batch_size == 2 and t.get("absent") is None and "data" in t
    with pytest.raises(AttributeError, match="cfg.data.missing"):
        t.data.missing
    for path in (None, str(tmp_path / "train.yaml")):
        assert tc.load_train_config(path).to_dict() == jc.load_train_config(path).to_dict()
    assert tc.load_decode_config().to_dict() == jc.load_decode_config().to_dict()
    assert tc.load_trans_config().to_dict() == jc.load_trans_config().to_dict()
    for path in (None, str(tmp_path / "eval.yaml")):
        src = tc.Config(path) if path else tc.Config({})
        jsrc = jc.Config(path) if path else jc.Config({})
        assert tc.static_shapes_from(src).__dict__ == jc.static_shapes_from(jsrc).__dict__


def test_configer_and_anchor_expr_equal_jax():
    src = {"a": {"b": {"c": 1}}}
    t, j = tc.Configer(json.loads(json.dumps(src))), jc.Configer(json.loads(json.dumps(src)))
    for c in (t, j):
        c.update(("a", "d"), 5)
        c.add(("e",), [1])
    assert t.to_dict() == j.to_dict()
    assert t.get("a", "b", "c") == j.get("a", "b", "c") and t.exists("a", "b")
    assert t.get("a", "z", default=3) == j.get("a", "z", default=3) == 3
    with pytest.raises(KeyError):
        t.add(("e",), 2)
    for expr in ("[2 ** 0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0)]",
                 "[(1.0, 1.0), (1.4, 0.7), (0.7, 1.4)]", "-3 * 2 + 1 - 4 / 8", 7):
        assert tc.parse_anchor_expr(expr) == jc.parse_anchor_expr(expr)
    with pytest.raises(ValueError):
        tc.parse_anchor_expr("__import__('os')")
