"""The port's data layer against the JAX package's on one synthetic
Cityscapes tree (written by the JAX ``tools/make_synthetic_cityscapes.py``,
256x512): ``CityscapesDataset``, ``DirDataset``, ``BatchLoader`` (serial and
prefetch thread) and ``pack_batch`` give the same images, packed labels and
infos bit for bit; ``device_prefetch`` hands the same batches over as
tensors; the prefetch thread joins when the consumer leaves early; what is
not ported raises. The port's synthetic tool writes the JAX tool's labels."""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from instance_segmentation_tpu import data as jdata
from instance_segmentation_tpu.configs import Configer as JConfiger
from instance_segmentation_tpu.data import cityscapes as jcs
from instance_segmentation_tpu.data.packing import pack_batch as j_pack_batch
from instance_segmentation_tpu.transforms import CommonTransforms as JTransforms
from instance_segmentation_torch import data as tdata
from instance_segmentation_torch.configs import Configer as TConfiger
from instance_segmentation_torch.data import cityscapes as tcs
from instance_segmentation_torch.data.packing import pack_batch as t_pack_batch
from instance_segmentation_torch.data.registry import device_prefetch
from instance_segmentation_torch.tools.make_synthetic_cityscapes import generate as t_generate
from instance_segmentation_torch.transforms import CommonTransforms as TTransforms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRANS = {"train_trans": {"trans_seq": ["resize"], "resize": {"target_size": 2}},
         "val_trans": {"trans_seq": ["resize"], "resize": {"target_size": 2}}}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_synthetic_cityscapes import generate
    root = str(tmp_path_factory.mktemp("data") / "cs")
    generate(root, splits=(("train", 3), ("val", 3)), h=256, w=512, seed=5,
             instances=(2, 4))
    return root


def _loaders(tree, phase, batch, dataset="cityscapes", **kw):
    data_dir = tree if dataset == "cityscapes" else os.path.join(tree, "leftImg8bit", phase)
    j = jdata.get_dataloader(batch, dataset, data_dir, phase,
                             transforms=JTransforms(JConfiger(TRANS), "val"),
                             max_instances=4, max_verts=16, num_workers=0, **kw)
    t = tdata.get_dataloader(batch, dataset, data_dir, phase,
                             transforms=TTransforms(TConfiger(TRANS), "val"),
                             max_instances=4, max_verts=16, num_workers=0, **kw)
    return j, t


def _assert_batches_equal(jb, tb):
    (ji, jp, jinf), (ti, tp, tinf) = jb, tb
    assert ti.dtype == np.uint8
    np.testing.assert_array_equal(ti, ji)
    assert (tp is None) == (jp is None)
    if tp is not None:
        for a, b in zip(tp, jp):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert [tuple(i) for i in tinf] == [tuple(i) for i in jinf]


def test_label_tables_and_parsing_equal_jax(tree):
    assert [tuple(l) for l in tcs.labels] == [tuple(l) for l in jcs.labels]
    assert tcs.class_labels == jcs.class_labels and tcs.num_cls == jcs.num_cls
    assert tdata.get_cls_num("cityscapes") == jdata.get_cls_num("cityscapes")
    assert tdata.get_cls_num("coco") == jdata.get_cls_num("coco")
    assert tdata.get_eval_labels("cityscapes") == jdata.get_eval_labels("cityscapes")
    label = {"objects": [{"label": "car", "polygon": [[1, 2], [30, 4], [9, 20]]},
                         {"label": "cargroup", "polygon": [[5, 5], [9, 5], [9, 9]]},
                         {"label": "caravan", "polygon": [[0, 0], [4, 0], [4, 4]]},
                         {"label": "road", "polygon": [[0, 0], [1, 0], [1, 1]]}]}
    for fn in ("parse_label_json", "parse_eval_label_json"):
        got, want = getattr(tcs, fn)(label), getattr(jcs, fn)(label)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert len(g) == len(w) and all(np.array_equal(a, b) for a, b in zip(g, w))


def test_cityscapes_dataset_equals_jax(tree):
    for phase in ("train", "val"):
        j = jcs.CityscapesDataset(tree, transforms=None, subset=phase)
        t = tcs.CityscapesDataset(tree, transforms=None, subset=phase)
        assert t.filenames == j.filenames and t.filenames_gt == j.filenames_gt
        for i in range(len(t)):
            (ti, (tc, tp), _), (ji, (jc, jp), _) = t[i], j[i]
            np.testing.assert_array_equal(ti, ji)
            assert tc == jc and all(np.array_equal(a, b) for a, b in zip(tp, jp))


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("batch", [2, 3])
def test_loader_batches_equal_jax(tree, prefetch, batch):
    j, t = _loaders(tree, "val", batch, prefetch=prefetch)
    assert len(t) == len(j)
    jb, tb = list(j), list(t)
    assert len(tb) == len(jb)
    for a, b in zip(jb, tb):
        _assert_batches_equal(a, b)


def test_dir_dataset_equals_jax(tree):
    j, t = _loaders(tree, "test", 2, dataset="dir", with_label=False)
    for a, b in zip(list(j), list(t)):
        _assert_batches_equal(a, b)


def test_pack_batch_equals_jax():
    rng = np.random.default_rng(3)
    labels = []
    for n in (0, 2, 7):     # an empty image, a few, more than max_instances
        labels.append(([int(c) for c in rng.integers(0, 8, n)],
                       [rng.integers(0, 200, (int(rng.integers(1, 40)), 2)).astype(np.int32)
                        for _ in range(n)]))
    for mi, mv in ((4, 16), (8, 64)):
        for a, b in zip(t_pack_batch(labels, mi, mv), j_pack_batch(labels, mi, mv)):
            np.testing.assert_array_equal(a, b)


def test_device_prefetch_hands_over_the_same_batches(tree):
    _, t = _loaders(tree, "val", 2)
    host = list(t)
    moved = list(device_prefetch(t, torch.device("cpu"), size=1))
    assert len(moved) == len(host)
    for (hi, hp, hinf), (mi, mp, minf) in zip(host, moved):
        assert torch.equal(mi, torch.from_numpy(hi)) and minf == hinf
        for a, b in zip(mp, hp):
            assert torch.equal(a, torch.from_numpy(b))


def test_prefetch_thread_joins_on_early_exit(tree):
    _, t = _loaders(tree, "train", 1, random=False)
    before = threading.active_count()
    it = iter(t)
    next(it)
    it.close()
    assert threading.active_count() == before
    moved = device_prefetch(t, torch.device("cpu"), size=1)
    next(moved)
    moved.close()
    assert threading.active_count() == before


def test_what_is_not_ported_raises(tree, tmp_path):
    """A COCO tree without its instances.json and a corrupt JPEG frame raise,
    naming the file (COCO and JPEG frames, the packed dataset and the worker
    pool, once listed here as not ported, are: tests/test_torch_coco.py,
    tests/test_torch_jpeg.py, tests/test_torch_loader.py)."""
    with pytest.raises(FileNotFoundError, match="instances.json"):
        tdata.get_dataloader(1, "coco", tree, "val")
    jpeg = tmp_path / "dir"
    jpeg.mkdir()
    (jpeg / "frame.jpg").write_bytes(b"\xff\xd8\xff\xe0rest")
    loader = tdata.get_dataloader(1, "dir", str(jpeg), "test", with_label=False, prefetch=0)
    with pytest.raises(ValueError, match="frame.jpg"):
        list(loader)


def test_port_synthetic_tool_writes_the_jax_labels(tree, tmp_path):
    root = str(tmp_path / "port")
    t_generate(root, splits=(("train", 3), ("val", 3)), h=256, w=512, seed=5,
               instances=(2, 4))
    for phase in ("train", "val"):
        j = jcs.CityscapesDataset(tree, subset=phase)
        t = tcs.CityscapesDataset(root, subset=phase)
        assert [os.path.basename(f) for f in t.filenames] == \
            [os.path.basename(f) for f in j.filenames]
        for a, b in zip(t.filenames_gt, j.filenames_gt):
            assert json.load(open(a)) == json.load(open(b))
        img = t[0][0]
        assert img.shape == (256, 512, 3) and img.dtype == np.uint8
