"""A configuration file whose backbone is MaxViT
(``configs/effseg-maxvitb-cityscapes.json``) turned into the port's settings
and the reference's, and the seeded weight tree both are given: the
functions of ``model.py`` that ``traffic/serve_closed.py`` calls, for the
reference of ``reference/efficientseg_maxvit.py`` and the tree of
``reference/weights_maxvit.py``.

The file states the backbone's stage table, its attention's widths and the
neck's; ``widths`` checks them against what the reference builds, so a file
cannot claim a size that is not run.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from benchmark.reference import efficientseg_maxvit as ref
from benchmark.reference.maxvit import TABLES, feature_channels
from benchmark.reference.weights_maxvit import seeded_tree

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def widths(config: Mapping) -> Dict:
    """The widths the reference builds for ``config``'s backbone and
    ``compound_coef``; raises where the file states others."""
    name, coef = config["backbone"], config["compound_coef"]
    if name not in TABLES:
        raise ValueError(f"{config['name']}: backbone {name!r} is not one of {sorted(TABLES)}")
    a = TABLES[name]
    built = {"stem": a.stem, "depths": list(a.depths), "channels": list(a.channels),
             "head_dim": a.head_dim, "partition": a.partition, "expand": a.expand,
             "se_ratio": a.se_ratio, "mlp_ratio": a.mlp_ratio,
             "feature_channels": feature_channels(name),
             "fpn_filters": ref.base.FPN_FILTERS[coef], "fpn_repeats": ref.base.FPN_REPEATS[coef],
             "fpn_fusion": "weighted" if coef < 6 else "sum",
             "box_class_repeats": ref.base.BOX_CLASS_REPEATS[coef],
             "pyramid_levels": list(range(3, 3 + ref.base.PYRAMID_LEVELS[coef]))}
    wrong = {k: (config.get(k), v) for k, v in built.items() if config.get(k) != v}
    if wrong:
        raise ValueError(f"{config['name']}: stated (file, built) widths differ: {wrong}")
    return built


def reference_config(config: Mapping, stated: bool = False) -> ref.EfficientSegConfig:
    """The reference's settings: float32 compute, or with ``stated`` the
    compute dtype the configuration states."""
    widths(config)
    dtype = DTYPES[config["compute_dtype"]] if stated else torch.float32
    return ref.EfficientSegConfig(num_classes=config["num_classes"],
                                  compound_coef=config["compound_coef"], compute_dtype=dtype,
                                  drop_connect_rate=config["drop_connect_rate"],
                                  backbone=config["backbone"])


def program_config(config: Mapping, quant: str = "none"):
    """The port's ``EfficientSegConfig`` of the file (the port has no int8
    path for MaxViT: ``quant`` "int8" raises there)."""
    from instance_segmentation_torch.models import EfficientSegConfig
    widths(config)
    return EfficientSegConfig(num_classes=config["num_classes"],
                              compound_coef=config["compound_coef"],
                              compute_dtype=DTYPES[config["compute_dtype"]],
                              drop_connect_rate=config["drop_connect_rate"], quant=quant,
                              backbone=config["backbone"])


def weight_tree(config: Mapping, seed: int, device: torch.device) -> Dict:
    """The seeded ``{"params", "batch_stats"}`` tree of the configuration."""
    with torch.device("meta"):
        shape = ref.EfficientSeg(reference_config(config))
    return seeded_tree(shape, seed, device)


def anchors(config: Mapping, device: torch.device) -> torch.Tensor:
    """The reference's anchors [A, 4] at the configuration's input size."""
    from benchmark.reference.anchors import generate_anchors
    cfg = reference_config(config)
    h, w = config["input_hw"]
    return torch.tensor(generate_anchors(h, w, pyramid_levels=cfg.pyramid_levels,
                                         anchor_scale=cfg.anchor_scale, scales=cfg.scales,
                                         ratios=cfg.ratios), device=device)
