"""The port's worker pool (``data/registry.py``, ``num_workers`` > 0) and its
packed Cityscapes path (``data/packed_dataset.py``,
``tools/preprocess_cityscapes.py``) against the serial loader and the JAX
package, on one synthetic Cityscapes tree (the JAX tool's, 128x256):

* two workers (forked from the fork server) give the serial loader's val
  batches, in order;
* one worker gives the JAX package's one-worker (fork) train batches bit for
  bit over two epochs of the default train transforms (resize, flip,
  brightness), and the epochs differ: the epoch mixes each worker's seed;
* the workers live on across complete epochs; an early exit stops them; a
  failing dataset item raises ``RuntimeError`` in the parent, and so does a
  worker that dies, also one cut off in the middle of sending a batch, with
  no fallback to serial loading; a program that ends
  with a pool still open leaves no process behind it (fork server included),
  and one that calls ``stop_fork_server`` with a pool open has no process
  left below it but multiprocessing's resource tracker;
* ``ISEG_DATA_WORKERS`` sets the pool's size when ``num_workers`` is None;
* the preprocess tool's outputs (``.npz`` arrays, ``_img.npy``, manifest)
  and the packed dataset's items and batches equal the JAX package's.
"""

import json
import multiprocessing as mp
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from instance_segmentation_torch import data as tdata
from instance_segmentation_torch.configs import Configer as TConfiger
from instance_segmentation_torch.configs import load_trans_config
from instance_segmentation_torch.data import cityscapes as tcs
from instance_segmentation_torch.data.packed_dataset import PackedCityscapesDataset
from instance_segmentation_torch.tools import preprocess_cityscapes as tprep
from instance_segmentation_torch.transforms import CommonTransforms as TTransforms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAL = {"val_trans": {"trans_seq": ["resize"], "resize": {"target_size": 2}}}


class FailingDataset(tcs.CityscapesDataset):
    """Raises on item 1."""

    def __getitem__(self, index):
        if index == 1:
            raise ValueError("item 1 cannot be read")
        return super().__getitem__(index)


class DyingDataset(tcs.CityscapesDataset):
    """Ends its process on item 2."""

    def __getitem__(self, index):
        if index == 2:
            os._exit(3)
        return super().__getitem__(index)


class DyingMidBatchDataset(tcs.CityscapesDataset):
    """Item 1 is a 16 MB image, and its process ends 0.5 s after reading
    it: while the parent is not reading, in the middle of sending it."""

    def __getitem__(self, index):
        img, label, info = super().__getitem__(index)
        if index == 1:
            threading.Timer(0.5, os._exit, (3,)).start()
            img = np.zeros((2048, 2048, 4), np.uint8)
        return img, label, info


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_synthetic_cityscapes import generate
    root = str(tmp_path_factory.mktemp("data") / "cs")
    generate(root, splits=(("train", 6), ("val", 5)), h=128, w=256, seed=7, instances=(2, 5))
    return root


def _assert_batches_equal(a, b):
    (ai, ap, ainf), (bi, bp, binf) = a, b
    assert ai.dtype == bi.dtype == np.uint8
    np.testing.assert_array_equal(ai, bi)
    assert (ap is None) == (bp is None)
    if ap is not None:
        for x, y in zip(ap, bp):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert [tuple(i) for i in ainf] == [tuple(i) for i in binf]


def _port_loader(tree, phase, batch, num_workers, transforms, dataset=None, **kw):
    loader = tdata.get_dataloader(batch, "cityscapes", tree, phase, transforms=transforms,
                                  max_instances=8, max_verts=32, num_workers=num_workers,
                                  **kw)
    if dataset is not None:
        loader.dataset = loader._maker.dataset = dataset
    return loader


def test_pool_gives_the_serial_val_batches(tree):
    val = TTransforms(TConfiger(VAL), "val")
    serial = list(_port_loader(tree, "val", 2, 0, val, prefetch=0))
    pooled = _port_loader(tree, "val", 2, 2, val)
    try:
        got = list(pooled)
        assert len(got) == len(serial) == 3            # the last batch is partial
        for a, b in zip(got, serial):
            _assert_batches_equal(a, b)
        procs = list(pooled._pool.procs)
        assert all(p.is_alive() for p in procs)         # kept after a complete epoch
        again = list(pooled)
        assert pooled._pool.procs == procs
        for a, b in zip(again, serial):
            _assert_batches_equal(a, b)
    finally:
        pooled.close()
    assert not any(p.is_alive() for p in procs)


def test_one_worker_gives_jax_batches_over_two_epochs(tree):
    from instance_segmentation_tpu import data as jdata
    from instance_segmentation_tpu.configs import Configer as JConfiger
    from instance_segmentation_tpu.transforms import CommonTransforms as JTransforms
    trans = load_trans_config().to_dict()
    j = jdata.get_dataloader(2, "cityscapes", tree, "train",
                             transforms=JTransforms(JConfiger(trans), "train", seed=3),
                             max_instances=8, max_verts=32, seed=3, num_workers=1)
    t = _port_loader(tree, "train", 2, 1, TTransforms(TConfiger(trans), "train", seed=3),
                     seed=3)
    try:
        epochs = []
        for _ in range(2):
            jb, tb = list(j), list(t)
            assert len(tb) == len(jb) == 3
            for a, b in zip(tb, jb):
                _assert_batches_equal(a, b)
            epochs.append(tb)
    finally:
        t.close()
    assert not all(np.array_equal(a[0], b[0]) for a, b in zip(*epochs))


def test_a_failing_item_raises_in_the_parent(tree):
    val = TTransforms(TConfiger(VAL), "val")
    loader = _port_loader(tree, "val", 1, 1, val,
                          dataset=FailingDataset(tree, val, subset="val"))
    with pytest.raises(RuntimeError, match="item 1 cannot be read"):
        list(loader)
    assert loader._pool is None


def test_a_dying_worker_raises_in_the_parent(tree):
    val = TTransforms(TConfiger(VAL), "val")
    loader = _port_loader(tree, "val", 1, 2, val,
                          dataset=DyingDataset(tree, val, subset="val"))
    with pytest.raises(RuntimeError, match="died"):
        list(loader)
    assert loader._pool is None and not mp.active_children()


def test_a_worker_dying_while_sending_raises_in_the_parent(tree):
    val = TTransforms(TConfiger(VAL), "val")
    loader = _port_loader(tree, "val", 1, 1, val,
                          dataset=DyingMidBatchDataset(tree, val, subset="val"))
    it = iter(loader)
    next(it)
    time.sleep(2.0)             # the worker ends with its next batch half in the pipe
    with pytest.raises(RuntimeError, match="died"):
        next(it)
    assert loader._pool is None and not mp.active_children()


def test_an_early_exit_leaves_no_live_worker(tree):
    val = TTransforms(TConfiger(VAL), "val")
    loader = _port_loader(tree, "val", 1, 2, val)
    it = iter(loader)
    next(it)
    procs = list(loader._pool.procs)
    it.close()
    assert loader._pool is None
    assert not any(p.is_alive() for p in procs) and not mp.active_children()


def _session_processes(sid):
    """The pids of the live processes of session ``sid`` (zombies excluded)."""
    pids = []
    for entry in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        if fields[0] != "Z" and int(fields[3]) == sid:
            pids.append(int(entry))
    return pids


def test_no_process_outlives_a_program_that_leaves_a_pool_open(tree, tmp_path):
    script = tmp_path / "open_pool.py"
    script.write_text(textwrap.dedent(f"""
        import multiprocessing.forkserver
        import sys
        sys.path.insert(0, {REPO!r})
        from instance_segmentation_torch import data as tdata
        from instance_segmentation_torch.configs import Configer
        from instance_segmentation_torch.transforms import CommonTransforms

        if __name__ == "__main__":
            val = CommonTransforms(Configer({VAL!r}), "val")
            loader = tdata.get_dataloader(1, "cityscapes", {tree!r}, "val", transforms=val,
                                          max_instances=8, max_verts=32, num_workers=2)
            batches = iter(loader)
            next(batches)
            print(multiprocessing.forkserver._forkserver._forkserver_pid,
                  *[p.pid for p in loader._pool.procs])
    """))
    # the output goes to a file: the server would hold a pipe open, and
    # reading it to its end would wait for the server
    out = tmp_path / "pids.txt"
    with open(out, "w") as f:
        proc = subprocess.Popen([sys.executable, str(script)], stdout=f,
                                start_new_session=True)
        proc.wait(timeout=120)
    assert proc.returncode == 0
    started = [int(pid) for pid in out.read_text().split()]
    assert len(started) == 3                 # the fork server and two workers ran
    assert _session_processes(proc.pid) == []


def test_stop_fork_server_leaves_no_process_but_the_resource_tracker(tree, tmp_path):
    """In a process of its own (no other test's pool can leak into it): a
    pool of two workers started and a batch read, then ``stop_fork_server``
    leaves no live descendant (read from ``/proc``) but multiprocessing's
    resource tracker, which ends with the process."""
    script = tmp_path / "stop_server.py"
    script.write_text(textwrap.dedent(f"""
        import multiprocessing.resource_tracker
        import os
        import sys
        sys.path.insert(0, {REPO!r})
        from instance_segmentation_torch import data as tdata
        from instance_segmentation_torch.configs import Configer
        from instance_segmentation_torch.data.registry import stop_fork_server
        from instance_segmentation_torch.transforms import CommonTransforms

        def descendants():
            parent = {{}}
            for entry in filter(str.isdigit, os.listdir("/proc")):
                try:
                    with open(f"/proc/{{entry}}/stat") as f:
                        fields = f.read().rsplit(")", 1)[1].split()
                except (OSError, IndexError):
                    continue
                if fields[0] != "Z":
                    parent[int(entry)] = int(fields[1])
            below, frontier = [], [os.getpid()]
            while frontier:
                frontier = [pid for pid, pp in parent.items() if pp in frontier]
                below += frontier
            return below

        if __name__ == "__main__":
            val = CommonTransforms(Configer({VAL!r}), "val")
            loader = tdata.get_dataloader(1, "cityscapes", {tree!r}, "val", transforms=val,
                                          max_instances=8, max_verts=32, num_workers=2)
            batches = iter(loader)
            next(batches)
            started = descendants()
            stop_fork_server()
            tracker = multiprocessing.resource_tracker._resource_tracker._pid
            print(len(started), *[pid for pid in descendants() if pid != tracker])
    """))
    # the output goes to a file: a server left running would hold a pipe open
    out = tmp_path / "left.txt"
    with open(out, "w") as f:
        proc = subprocess.Popen([sys.executable, str(script)], stdout=f,
                                start_new_session=True)
        proc.wait(timeout=120)
    assert proc.returncode == 0
    started, *left = (int(n) for n in out.read_text().split())
    assert started >= 3                      # the fork server and two workers ran
    assert left == []


def test_workers_from_the_environment(tree, monkeypatch):
    monkeypatch.setenv("ISEG_DATA_WORKERS", "3")
    assert tdata.get_dataloader(1, "cityscapes", tree, "val").num_workers == 3
    assert tdata.get_dataloader(1, "cityscapes", tree, "val", num_workers=0).num_workers == 0
    monkeypatch.delenv("ISEG_DATA_WORKERS")
    assert tdata.get_dataloader(1, "cityscapes", tree, "val").num_workers == 0


@pytest.fixture(scope="module")
def packed(tree, tmp_path_factory):
    """The JAX tool's and the port's outputs (with --cache_images) for the
    train split; the port's through two workers."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import preprocess_cityscapes as jprep
    out = tmp_path_factory.mktemp("packed")
    jdir, tdir = str(out / "jax"), str(out / "port")
    jprep.preprocess(tree, "train", jdir, max_instances=8, max_verts=32, workers=1,
                     cache_images=True)
    tprep.main(["--root", tree, "--subset", "train", "--out", tdir, "--max_instances", "8",
                "--max_verts", "32", "--workers", "2", "--cache_images"])
    return jdir, tdir


def test_preprocess_tool_outputs_equal_jax(packed):
    jdir, tdir = packed
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    names = sorted(os.listdir(jdir))
    assert sum(n.endswith("_img.npy") for n in names) == 6
    for name in names:
        if name.endswith(".npz"):
            a, b = np.load(os.path.join(tdir, name)), np.load(os.path.join(jdir, name))
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        elif name.endswith(".npy"):
            a, b = np.load(os.path.join(tdir, name)), np.load(os.path.join(jdir, name))
            assert a.dtype == b.dtype == np.uint8 and a.shape == (64, 128, 3)
            np.testing.assert_array_equal(a, b)
    tm, jm = (json.load(open(os.path.join(d, "manifest.json"))) for d in (tdir, jdir))
    assert [os.path.basename(f) for f in tm.pop("files")] == \
        [os.path.basename(f) for f in jm.pop("files")]
    assert tm == jm


@pytest.mark.parametrize("cached", [True, False], ids=["image_cache", "png"])
def test_packed_dataset_and_batches_equal_jax(tree, packed, cached, tmp_path):
    from instance_segmentation_tpu import data as jdata
    from instance_segmentation_tpu.data.packed_dataset import PackedCityscapesDataset as JPacked
    jdir, tdir = packed
    if not cached:                  # the labels alone: frames decoded and resized
        for d in (jdir, tdir):
            dst = tmp_path / os.path.basename(d)
            dst.mkdir()
            files = []
            for name in os.listdir(d):
                if name.endswith(".npz"):
                    os.link(os.path.join(d, name), dst / name)
                    files.append(str(dst / name))
            manifest = json.load(open(os.path.join(d, "manifest.json")))
            (dst / "manifest.json").write_text(json.dumps({**manifest, "files": files}))
        jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    j, t = JPacked(tree, jdir, "train"), PackedCityscapesDataset(tree, tdir, "train")
    assert len(t) == len(j) == 6
    for i in range(len(t)):
        (ti, tl, tinfo), (ji, jl, jinfo) = t[i], j[i]
        np.testing.assert_array_equal(ti, ji)
        assert tl[0] == jl[0] == "packed"
        for a, b in zip(tl[1:], jl[1:]):
            np.testing.assert_array_equal(a, b)
        assert tuple(tinfo) == tuple(jinfo)
    jl = jdata.registry.BatchLoader(j, 3, shuffle=True, drop_last=True, max_instances=8,
                                    max_verts=32, seed=2, prefetch=0)
    tl = tdata.registry.BatchLoader(t, 3, shuffle=True, drop_last=True, max_instances=8,
                                    max_verts=32, seed=2, prefetch=0)
    for a, b in zip(list(tl), list(jl)):
        _assert_batches_equal(a, b)
    built = tdata.datasetBuildersMap["cityscapes_packed"](tree, "train").get_dataset(
        packed_dir=tdir, transforms=None)
    assert isinstance(built, PackedCityscapesDataset) and len(built) == 6
