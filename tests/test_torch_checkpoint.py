"""The port's checkpoints (instance_segmentation_torch/utils/checkpoint.py) on
the CPU: the reference's file names and training order, a save/restore round
trip of a ``Trainer``, a resumed step bitwise equal to an uninterrupted one
(drop-connect and device augmentation on), and the non-strict warm start
from a backbone-only ``{params, batch_stats}`` tree with its counts. The
two-rank save and restore is in test_torch_parallel.py."""

import numpy as np
import pytest
import torch

from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig
from instance_segmentation_torch.training.synthetic import small_train_batch
from instance_segmentation_torch.training.train_step import Trainer
from instance_segmentation_torch.utils.checkpoint import (
    CheckpointManager, checkpoint_name, load_pretrained,
)
from instance_segmentation_torch.weights import export_flax_variables, init_random

torch.set_num_threads(2)
H, W, M, P = 128, 256, 8, 64


def _trainer(seed=0, **kw):
    cfg = EfficientSegConfig(num_classes=8, compound_coef=0)
    return Trainer(cfg, torch.Generator().manual_seed(seed), (H, W), max_points=P,
                   device=torch.device("cpu"), drop_seed=3, device_aug=True, aug_seed=4, **kw)


def test_names_and_training_order(tmp_path):
    assert checkpoint_name(7) == "efficient_weights_00000007.pth"
    assert checkpoint_name(7, 999) == "efficient_weights_0007_0999.pth"
    manager = CheckpointManager(str(tmp_path))
    assert manager.list_checkpoints() == []
    names = [checkpoint_name(2), checkpoint_name(1, 5), checkpoint_name(2, 10),
             checkpoint_name(1), checkpoint_name(2, 3), checkpoint_name(10, 1)]
    for name in names + ["efficient_weights_7.pth", "other.pth",
                         checkpoint_name(3) + ".tmp"]:
        (tmp_path / name).write_bytes(b"")
    assert manager.list_checkpoints() == [
        checkpoint_name(1, 5), checkpoint_name(1), checkpoint_name(2, 3),
        checkpoint_name(2, 10), checkpoint_name(2), checkpoint_name(10, 1)]


def test_restore_without_a_checkpoint(tmp_path):
    trainer = _trainer()
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    assert CheckpointManager(str(tmp_path)).restore_latest(trainer) == (0, 0.0)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, before[k])


def test_save_restore_round_trip_and_resumed_step(tmp_path):
    """A trainer takes a step and is saved mid-epoch; a fresh trainer (other
    weights) restores the latest file and gets (epoch + 1, best_ap), the
    weights, batch-norm statistics, optimizer state, step count and
    generators; then its next two steps equal, bit for bit, those of the
    trainer that went on."""
    frames, labels = small_train_batch(2, M, H, W, seed=5)
    going = _trainer()
    going.step(frames, *labels)
    manager = CheckpointManager(str(tmp_path))
    manager.save(going, epoch=0, best_ap=0.5)                          # older
    path = manager.save(going, epoch=1, best_ap=0.75, iter_id=3)
    manager.wait()
    assert path.endswith(checkpoint_name(1, 3))
    assert manager.list_checkpoints()[-1] == checkpoint_name(1, 3)
    fresh = _trainer(seed=1)
    assert manager.restore_latest(fresh) == (2, 0.75)
    for key, value in going.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[key], value), key
    want_opt, got_opt = going.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert want_opt["param_groups"] == got_opt["param_groups"]
    for i, state in want_opt["state"].items():
        for name, value in state.items():
            assert torch.equal(got_opt["state"][i][name], value), (i, name)
    assert fresh.steps == going.steps == 1
    assert torch.equal(fresh.drop_generator.get_state(), going.drop_generator.get_state())
    assert torch.equal(fresh.aug_generator.get_state(), going.aug_generator.get_state())
    for _ in range(2):
        want, got = going.step(frames, *labels), fresh.step(frames, *labels)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for (key, p), q in zip(going.model.named_parameters(), fresh.model.parameters()):
        assert torch.equal(p, q), key
    assert manager.restore_named(checkpoint_name(0), fresh) == (1, 0.5)


def test_save_reports_a_failed_write(tmp_path):
    manager = CheckpointManager(str(tmp_path))
    trainer = _trainer()
    (tmp_path / (checkpoint_name(4) + ".tmp")).mkdir()           # the write cannot land
    manager.save(trainer, epoch=4, best_ap=0.0)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        manager.wait()
    manager.wait()                                                # reported once


def test_load_pretrained_backbone_subset():
    """Backbone params and batch stats from another model, plus a leaf with no
    counterpart and one of the wrong shape: the backbone is taken, the rest
    of the model keeps its values, and the counts are (matched, total)."""
    cfg = EfficientSegConfig(num_classes=8, compound_coef=0)
    source, model = EfficientSeg(cfg), EfficientSeg(cfg)
    init_random(source, torch.Generator().manual_seed(1))
    init_random(model, torch.Generator().manual_seed(2))
    with torch.no_grad():
        for m in source.modules():
            if hasattr(m, "running_var"):
                m.running_var.uniform_(0.5, 1.5)
    full = export_flax_variables(source)
    tree = {coll: {"backbone": full[coll]["backbone"]} for coll in ("params", "batch_stats")}

    def n_leaves(t):
        return sum(n_leaves(v) for v in t.values()) if isinstance(t, dict) else 1
    n_backbone = n_leaves(tree)
    tree["params"]["no_such_module"] = {"kernel": np.zeros((3, 3), np.float32)}
    stem = tree["params"]["backbone"]["stem_conv"]["Conv_0"]
    stem["kernel"] = stem["kernel"][..., :4]                       # wrong shape
    before = {k: v.clone() for k, v in model.state_dict().items()}
    matched, total = load_pretrained(tree, model)
    assert (matched, total) == (n_backbone - 1, n_backbone + 1)
    src = source.state_dict()
    for key, value in model.state_dict().items():
        if key.startswith("backbone_net.") and "_conv_stem" not in key:
            assert torch.equal(value, src[key]), key
        else:
            assert torch.equal(value, before[key]), key
