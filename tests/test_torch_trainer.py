"""The port's epoch loop (``training/trainer.py``) and train entry point
(``train.py``) against the JAX package, at EfficientSeg-B0, 128x256 from
256x512 frames, batch 2, M=8, V=16, P=128, float32, the default train
transforms (resize, flip, brightness):

* the epoch loop: JAX's ``training.Trainer`` and the port's, built from the
  same configs with the JAX state's weights handed to the port (drop-connect
  off on both sides, the JAX Pallas kernels in interpret mode), see the
  same batches bit for bit over ``max_iter`` 2, and their stats agree: the
  first step's to rtol 1e-4 (``STAT_TOL``, as ``test_torch_train.py``; they
  differ by at most 3.0e-6), the second's, after one Adam update on each
  side, to rtol 1e-4 too (``SECOND_TOL``; they differ by at most 7.4e-6);
  the numbers of their log lines agree to the lines' 4 decimals;
* the ``save_span`` checkpoint is the state after its step; a NaN loss
  raises one step late; resume restores the epoch and the weights; the
  in-loop eval writes ``{epoch}_dets.json``, raises ``best_ap`` and leaves
  the batch-norm buffers and the drop-connect generator as they were;
* ``pretrained_path`` in its three formats gives JAX's ``load_pretrained``
  counts, and the numpy copy of ``convert_state_dict`` equals the original;
* the CLI trains, checkpoints and resumes on the CPU, and the port's
  ``evaluate`` scores its checkpoints; without ``--device`` it needs CUDA;
* two ranks over gloo: one step of the epoch loop gives the 1-rank stats
  to rtol 1e-5 (as ``tools/multichip.py`` holds the step).
"""

import functools
import json
import os
import re
import sys

import numpy as np
import pytest
import torch
import yaml

from instance_segmentation_torch import evaluate as t_evaluate
from instance_segmentation_torch import train as t_train
from instance_segmentation_torch.configs import Config, Configer, load_trans_config
from instance_segmentation_torch.models import efficientnet as teff
from instance_segmentation_torch.parallel import multihost
from instance_segmentation_torch.training import Trainer
from instance_segmentation_torch.training.trainer import LOSS_NAMES
from instance_segmentation_torch.utils.checkpoint import load_pretrained_file
from instance_segmentation_torch.weights import export_flax_variables

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 128, 256
STAT_TOL = dict(rtol=1e-4, atol=0.0)
SECOND_TOL = dict(rtol=1e-4, atol=0.0)
RANK_TOL = dict(rtol=1e-5, atol=0.0)
DECODE = {"cls_th": 0.3, "iou_th": 0.2, "kp_th": 2000, "obj_pixel_th": 2, "wh_delta": 0.1,
          "alpha_ratio": 2, "draw_flag": False}
CPU = torch.device("cpu")


class Recorder:
    """A logger that keeps every line (any level) and scalar."""

    def __init__(self):
        self.lines, self.scalars = [], []

    def write(self, msg="", end="\n", level=0):
        self.lines.append(msg)

    def scalar_summary(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))


def _no_drop(x, rate, generator):
    return x


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_synthetic_cityscapes import generate
    base = tmp_path_factory.mktemp("trainer")
    root = str(base / "data")
    generate(root, splits=(("train", 4), ("val", 2)), h=2 * H, w=2 * W, seed=5,
             instances=(2, 4))
    (base / "decode.yaml").write_text(yaml.safe_dump(DECODE))
    return base, root


def _cfg(tree, save_dir, **top):
    base, root = tree
    cfg = {"data": {"train_dir": root, "save_dir": str(save_dir), "dataset": "cityscapes",
                    "batch_size": 2, "num_classes": -1},
           "optimizer": {"lr": "2e-5", "type": "Adam", "momentum": 0.9},
           "max_iter": 2, "num_epochs": 1, "save_span": 1000, "seed": 1, "compound_coef": 0,
           "anchors_scales": "[2 ** 0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0)]",
           "anchors_ratios": "[(1.0, 1.0), (1.4, 0.7), (0.7, 1.4)]",
           "pretrained_path": None, "decode_cfg_path": str(base / "decode.yaml"),
           "trans_cfg_path": None, "start_eval_epoch": 1000,
           "tpu": {"compute_dtype": "float32", "remat": False, "input_size": [H, W]},
           "static": {"max_instances": 8, "max_vertices": 16, "max_points": 128}}
    cfg.update(top)
    return cfg


def _port(tree, save_dir, weights=None, logger=None, **top):
    cfg = _cfg(tree, save_dir, **top)
    return Trainer(Config(cfg), Config(DECODE), load_trans_config(), logger or Recorder(),
                   device=CPU, weights=weights)


def _record_steps(trainer, store):
    """Wrap the step trainer's step: keep each batch (numpy) and its stats."""
    real = trainer.step_trainer.step

    def step(images, polys, n_verts, cls_ids):
        stats = real(images, polys, n_verts, cls_ids)
        store.append({"batch": [np.array(torch.as_tensor(a).cpu())
                                for a in (images, polys, n_verts, cls_ids)],
                      "stats": {k: float(v) for k, v in stats.items()}})
        return stats
    trainer.step_trainer.step = step


def _log_numbers(lines):
    """{iteration: [the losses of its line]} of the per-iteration lines."""
    out = {}
    for line in lines:
        m = re.match(r"train per epoch: \[\d+\]\[(\d+)/\d+\]", line)
        if m:
            out[int(m.group(1))] = [float(re.search(rf"\|{k}:([-\d.naninf]+)", line).group(1))
                                    for k in LOSS_NAMES]
    return out


@pytest.fixture(scope="module")
def epoch_case(tree, tmp_path_factory):
    """One epoch of max_iter 2 through JAX's Trainer and the port's."""
    import jax
    import instance_segmentation_tpu.losses.ae_pallas as aep
    import instance_segmentation_tpu.losses.minr2_pallas as mp2
    import instance_segmentation_tpu.losses.rasterize_pallas as rp
    import instance_segmentation_tpu.models.efficientnet as jeff
    from instance_segmentation_tpu.configs import Config as JConfig
    from instance_segmentation_tpu.configs import Configer as JConfiger
    from instance_segmentation_tpu.training import Trainer as JTrainer

    out = tmp_path_factory.mktemp("epoch")
    cfg = _cfg(tree, out / "jax")
    saved = (aep.INTERPRET, rp.INTERPRET, mp2.INTERPRET, jeff.drop_connect, teff.drop_connect)
    aep.INTERPRET = rp.INTERPRET = mp2.INTERPRET = True
    jeff.drop_connect = lambda x, rate, deterministic, rng: x
    teff.drop_connect = _no_drop
    try:
        j_log = Recorder()
        jt = JTrainer(JConfig(cfg), JConfig(DECODE), JConfiger(load_trans_config().to_dict()),
                      j_log)
        weights = {"params": jax.device_get(jt.state.params),
                   "batch_stats": jax.device_get(jt.state.batch_stats)}
        j_steps = []
        real = jt.train_step

        def j_step(state, images, polys, n_verts, cls_ids, rng):
            state, stats = real(state, images, polys, n_verts, cls_ids, rng)
            j_steps.append({"batch": [np.asarray(a) for a in (images, polys, n_verts, cls_ids)],
                            "stats": {k: float(v) for k, v in stats.items()}})
            return state, stats
        jt.train_step = j_step
        jt.train_epoch(jt.make_loaders()[0], 0)

        t_log = Recorder()
        pt = _port(tree, out / "port", weights=weights, logger=t_log)
        t_steps = []
        _record_steps(pt, t_steps)
        loader = pt.make_loaders()[0]
        pt.train_epoch(loader, 0)
        loader.close()
    finally:
        (aep.INTERPRET, rp.INTERPRET, mp2.INTERPRET, jeff.drop_connect,
         teff.drop_connect) = saved
    return j_steps, t_steps, j_log, t_log


def test_epoch_loop_sees_jax_batches(epoch_case):
    j_steps, t_steps, _, _ = epoch_case
    assert len(t_steps) == len(j_steps) == 2
    for j, t in zip(j_steps, t_steps):
        for a, b in zip(t["batch"], j["batch"]):
            np.testing.assert_array_equal(a.astype(b.dtype), b)
            assert a.shape == b.shape
        assert t["batch"][0].dtype == np.uint8


def test_epoch_loop_stats_and_log_lines_match_jax(epoch_case):
    j_steps, t_steps, j_log, t_log = epoch_case
    for i, tol in ((0, STAT_TOL), (1, SECOND_TOL)):
        want, got = j_steps[i]["stats"], t_steps[i]["stats"]
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.isfinite(got[k])
            np.testing.assert_allclose(got[k], want[k], err_msg=f"iter {i} {k}", **tol)
    j_nums, t_nums = _log_numbers(j_log.lines), _log_numbers(t_log.lines)
    assert sorted(t_nums) == sorted(j_nums) == [0, 1]
    for i in (0, 1):
        for a, b in zip(t_nums[i], j_nums[i]):
            assert abs(a - b) <= 1e-4 + SECOND_TOL["rtol"] * abs(b), (i, t_nums[i], j_nums[i])


def test_save_span_checkpoint_is_the_state_after_its_step(tree, tmp_path):
    trainer = _port(tree, tmp_path, save_span=1)
    after = []
    real = trainer.step_trainer.step

    def step(*args):
        stats = real(*args)
        after.append({k: v.clone() for k, v in trainer.step_trainer.model.state_dict().items()})
        return stats
    trainer.step_trainer.step = step
    loader = trainer.make_loaders()[0]
    trainer.train_epoch(loader, 0)
    trainer.ckpt.wait()
    assert sorted(os.listdir(tmp_path)) == ["efficient_weights_0000_0000.pth",
                                            "efficient_weights_0000_0001.pth"]
    for i in (0, 1):
        saved = torch.load(tmp_path / f"efficient_weights_0000_000{i}.pth", weights_only=True)
        assert saved["step"] == i + 1 and saved["epoch"] == 0
        for k, v in after[i].items():
            assert torch.equal(saved["model"][k], v), (i, k)


def test_nan_loss_raises_one_step_late(tree, tmp_path):
    trainer = _port(tree, tmp_path)
    calls = []
    real = trainer.step_trainer.step

    def step(*args):
        stats = dict(real(*args))
        if not calls:
            stats["total_loss"] = torch.tensor(float("nan"))
        calls.append(1)
        return stats
    trainer.step_trainer.step = step
    with pytest.raises(RuntimeError, match=r"loss nan at epoch 0 iter 0"):
        trainer.train_epoch(trainer.make_loaders()[0], 0)
    assert len(calls) == 2          # raised while the next step was queued


def test_resume_restores_epoch_and_weights(tree, tmp_path):
    first = _port(tree, tmp_path, max_iter=1)
    first.train()
    saved = {k: v.clone() for k, v in first.step_trainer.model.state_dict().items()}
    log = Recorder()
    again = _port(tree, tmp_path, max_iter=1, num_epochs=2, logger=log)
    assert (again.start_epoch, again.best_ap) == (1, 0.0)
    assert any("resumed from epoch 0" in line for line in log.lines)
    for k, v in again.step_trainer.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert again.step_trainer.steps == 1


def test_in_loop_eval_updates_best_ap_and_leaves_training_state(tree, tmp_path, monkeypatch):
    from instance_segmentation_torch.training import trainer as trainer_mod
    trainer = _port(tree, tmp_path, max_iter=1, start_eval_epoch=0)
    model = trainer.step_trainer.model
    real = trainer_mod.evaluate_model
    seen = {}

    def evaluate(*args, **kwargs):
        seen["buffers"] = {k: v.clone() for k, v in model.named_buffers()}
        seen["drop"] = trainer.step_trainer.drop_generator.get_state().clone()
        epoch, _, results = real(*args, **kwargs)
        return epoch, 0.25, results                 # an AP above the best so far
    monkeypatch.setattr(trainer_mod, "evaluate_model", evaluate)
    trainer.train()
    assert os.path.exists(tmp_path / "0_dets.json")
    assert len(json.load(open(tmp_path / "0_dets.json"))) == 2
    assert trainer.best_ap == 0.25
    assert model.training
    for k, v in model.named_buffers():
        assert torch.equal(v, seen["buffers"][k]), k
    assert torch.equal(trainer.step_trainer.drop_generator.get_state(), seen["drop"])


@functools.cache
def _jax_state():
    import jax
    from instance_segmentation_tpu.models import EfficientSeg as JSeg
    from instance_segmentation_tpu.models import EfficientSegConfig as JCfg
    from instance_segmentation_tpu.parallel import create_train_state
    from instance_segmentation_tpu.parallel.train_step import make_optimizer
    return create_train_state(JSeg(JCfg(num_classes=8, compound_coef=0)), jax.random.PRNGKey(1),
                              (1, H, W, 3), make_optimizer("Adam", 1e-4))


def _orbax_counts(tree_np, tmp_path, name):
    """JAX's load_pretrained counts on ``tree_np`` saved as an orbax tree."""
    import orbax.checkpoint as ocp
    from instance_segmentation_tpu.utils.checkpoint import load_pretrained
    path = str(tmp_path / name)
    ocp.Checkpointer(ocp.StandardCheckpointHandler()).save(
        path, args=ocp.args.StandardSave(tree_np))
    _, matched, total = load_pretrained(path, _jax_state())
    return matched, total


def test_pretrained_path_counts_equal_jax_in_three_formats(tree, tmp_path):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from convert_torch_weights import convert_state_dict as j_convert
    from instance_segmentation_torch.utils.convert_torch_weights import convert_state_dict
    source = _port(tree, tmp_path / "src")
    with torch.no_grad():
        for p in source.step_trainer.model.parameters():
            p.add_(0.01)
    target = _port(tree, tmp_path / "dst")
    model = target.step_trainer.model
    full = export_flax_variables(source.step_trainer.model)

    # 1: a tree, the backbone only, with a leaf of another shape and one
    # the model lacks
    subset = {c: {"backbone": full[c]["backbone"]} for c in ("params", "batch_stats")}
    subset["params"]["no_such_module"] = {"kernel": np.zeros((3, 3), np.float32)}
    stem = subset["params"]["backbone"]["stem_conv"]["Conv_0"]
    stem["kernel"] = stem["kernel"][..., :4].copy()
    torch.save(subset, tmp_path / "tree.pth")
    # 2: a checkpoint of the port; 3: the reference's {"state_dict": ...}
    source.ckpt.save(source.step_trainer, 3, 0.0)
    source.ckpt.wait()
    sd = {k: v.numpy() for k, v in source.step_trainer.model.state_dict().items()}
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "reference.pth")
    template = export_flax_variables(model)
    converted, n = convert_state_dict(sd, template, 0)
    want, n_want = j_convert(sd, template, 0)
    assert n == n_want > 300
    for c in ("params", "batch_stats"):
        import jax
        for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(converted[c])[0],
                                     jax.tree_util.tree_flatten_with_path(want[c])[0]):
            np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))

    cases = {"tree": (tmp_path / "tree.pth", subset),
             "checkpoint": (tmp_path / "src" / "efficient_weights_00000003.pth", converted),
             "state_dict": (tmp_path / "reference.pth", converted)}
    for name, (path, tree_np) in cases.items():
        fresh = _port(tree, tmp_path / f"dst_{name}")
        got = load_pretrained_file(str(path), fresh.step_trainer.model)
        assert got == _orbax_counts(tree_np, tmp_path, f"orbax_{name}"), name
        if name != "tree":      # the whole model is the source's
            for k, v in fresh.step_trainer.model.state_dict().items():
                assert torch.equal(v, source.step_trainer.model.state_dict()[k]), (name, k)
    log = Recorder()
    warm = _port(tree, tmp_path / "dst", pretrained_path=str(tmp_path / "reference.pth"),
                 logger=log)
    assert warm.start_epoch == 0
    assert any("pretrained warm start from" in line for line in log.lines)


def test_train_cli_checkpoints_resumes_and_evaluates_on_cpu(tree, tmp_path, capsys):
    base, root = tree
    cfg = _cfg(tree, tmp_path / "run", num_epochs=2, max_iter=1, save_span=1,
               start_eval_epoch=1)
    cfg["trans_cfg_path"] = None                          # the default transforms
    (tmp_path / "train.yaml").write_text(yaml.safe_dump(cfg))
    t_train.main(["--cfg_path", str(tmp_path / "train.yaml"), "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "run"))
    assert {"efficient_weights_00000000.pth", "efficient_weights_00000001.pth",
            "efficient_weights_0000_0000.pth", "1_dets.json"} <= set(names)
    out = capsys.readouterr().out
    assert "start to train..." in out and "[1] AP=" in out and "the best mAP" in out
    cfg["num_epochs"] = 3
    (tmp_path / "train.yaml").write_text(yaml.safe_dump(cfg))
    t_train.main(["--cfg_path", str(tmp_path / "train.yaml"), "--device", "cpu"])
    assert "resumed from epoch 1" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "run" / "efficient_weights_00000002.pth")

    ev = {"data": {"eval_dir": root, "save_dir": str(tmp_path / "eval"), "dataset": "cityscapes",
                   "batch_size": 2, "num_classes": -1, "subset": "val"},
          "seed": 1, "compound_coef": 0,
          "weights_path": str(tmp_path / "run" / "efficient_weights_00000002.pth"),
          "weights_dir": None, "decode_cfg_path": str(base / "decode.yaml"),
          "trans_cfg_path": None, "tpu": {"input_size": [H, W]},
          "static": {"max_instances": 8, "max_vertices": 16, "max_points": 128}}
    (tmp_path / "eval.yaml").write_text(yaml.safe_dump(ev))
    t_evaluate.main(["--cfg_path", str(tmp_path / "eval.yaml"), "--device", "cpu"])
    assert len(json.load(open(tmp_path / "eval" / "3_dets.json"))) == 2
    assert "[3] AP=" in capsys.readouterr().out

    missing = dict(cfg, data=dict(cfg["data"], train_dir=str(tmp_path / "nowhere")))
    (tmp_path / "missing.yaml").write_text(yaml.safe_dump(missing))
    with pytest.raises(FileNotFoundError, match="train dir"):
        t_train.main(["--cfg_path", str(tmp_path / "missing.yaml"), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_train.main(["--cfg_path", str(tmp_path / "train.yaml")])


def _rank(rank, world, init_method, tree, out_dir):
    torch.set_num_threads(2)
    teff.drop_connect = _no_drop
    multihost.maybe_initialize("cpu", init_method=init_method, rank=rank, world_size=world)
    import torch.distributed as dist
    try:
        cfg = _cfg(tree, os.path.join(out_dir, "ckpt"), max_iter=1)
        trainer = Trainer(Config(cfg), Config(DECODE), load_trans_config(), Recorder(),
                          device=CPU, group=dist.group.WORLD)
        steps = []
        _record_steps(trainer, steps)
        trainer.train_epoch(trainer.make_loaders()[0], 0)
        torch.save(steps, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_two_ranks_give_the_one_rank_stats(tree, tmp_path):
    multihost.spawn(_rank, 2, (f"file://{tmp_path}/rendezvous", tree, str(tmp_path)),
                    timeout=300)
    saved, teff.drop_connect = teff.drop_connect, _no_drop
    try:
        one = _port(tree, tmp_path / "one", max_iter=1)
        steps = []
        _record_steps(one, steps)
        one.train_epoch(one.make_loaders()[0], 0)
    finally:
        teff.drop_connect = saved
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        assert len(got) == 1
        for a, b in zip(got[0]["batch"], steps[0]["batch"]):
            np.testing.assert_array_equal(a, b)
        for k, v in steps[0]["stats"].items():
            np.testing.assert_allclose(got[0]["stats"][k], v, err_msg=f"rank {r} {k}",
                                       **RANK_TOL)
