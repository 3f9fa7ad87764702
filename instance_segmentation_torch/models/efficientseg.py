"""EfficientSeg: EfficientNet backbone -> BiFPN (P3..P7; P3..P8 at
compound_coef 8) -> anchor box/class
heads, plus the U-Net kp/ae/tan decoder over [input, P1..P5].

``cfg.compound_coef`` sets the BiFPN, the heads and their anchors, and by
default the backbone (EfficientNet-B``BACKBONE_COEF[coef]``);
``cfg.backbone`` names another (``BACKBONES``: the B-series or
EfficientNetV2-S/M/L of ``models/efficientnet.py``, or MaxViT-B of
``models/maxvit.py``), whose P3..P5 the BiFPN then takes.

Counterpart of ``instance_segmentation_tpu/models/efficientseg.py`` with the
standard layout (``apply(train=..., packed_heads=False)``, no space-to-depth).
Input: NHWC uint8 (or float) images; normalization happens inside the model.
Outputs in eval mode, in the reference layouts:

    kp:  (B, H, W, 1) float32 logits
    ae:  (B, H, W, 4) float32 (2 offsets + 2 log-sigmas)
    tan: (B, H, W, 2) float32
    regression:     (B, A, 4) float32 (dy, dx, dh, dw)
    classification: (B, A, C) float32 sigmoid scores

In training mode (``.train()``) the dense heads come out in the reference's
``planar_heads`` layout: kp as one [B, H, W] float32 plane, ae as a tuple of
four and tan as a tuple of two such planes. They are channel views of the
NCHW head outputs, not copies.

Inside, tensors are NCHW in ``compute_dtype``.

With ``cfg.remat`` the training forward keeps only the inputs of the
backbone and of the U-Net decoder (the two modules the reference wraps in
``nn.remat``) and recomputes their activations in the backward
(``torch.utils.checkpoint``, non-reentrant). The recompute leaves the
batch-norm running statistics alone and replays the drop-connect masks of
the forward (the backbone generator is rewound for it), so a step with
``remat`` computes what a step without it computes.

``cfg.quant == "int8"`` (reference ``quant``) runs the MBConv expand and
project convs, the fused blocks' 1x1 project convs and the U-Net's 3x3
convs through the int8 path outside
training (``layers.int8_conv2d``), with the float model's parameters; a
MaxViT backbone has no int8 path, and the config raises.

Under a spatial mesh (``parallel/spatial.sharded(mesh)``, S > 1 spatial
ranks) the forward takes this rank's W slab of the frames
(``parallel/mesh.batch_shard``): the backbone and the U-Net run on slabs
(halo-exchanged convs, squeeze-and-excitation means summed over the
group), P3..P5 are gathered (``pin_data_sharding``) and the BiFPN and the
box heads run whole on every rank, and kp/ae/tan are gathered along W. It
returns the five outputs of the whole frames, in the layouts above, on
every rank of the group. That is the JAX package's W-sharded eval forward;
training, ``remat``, ``quant`` and a MaxViT backbone (whose grid attention
spans the whole map) raise under it.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from instance_segmentation_torch.models import efficientnet, maxvit
from instance_segmentation_torch.models.bifpn import BiFPN
from instance_segmentation_torch.models.efficientnet import EfficientNetFeatures
from instance_segmentation_torch.models.heads import Classifier, Regressor
from instance_segmentation_torch.models.layers import (
    Conv2d, Conv2dSame, cast_convs, pin_data_sharding,
)
from instance_segmentation_torch.models.unet_decoder import UNetDecoder
from instance_segmentation_torch.parallel import spatial

# Per-compound-coefficient scaling tables (same as the reference).
BACKBONE_COEF = [0, 1, 2, 3, 4, 5, 6, 6, 7]
FPN_FILTERS = [64, 88, 112, 160, 224, 288, 384, 384, 384]
FPN_REPEATS = [3, 4, 5, 6, 7, 7, 8, 8, 8]
BOX_CLASS_REPEATS = [3, 3, 3, 4, 4, 4, 5, 5, 5]
PYRAMID_LEVELS = [5, 5, 5, 5, 5, 5, 5, 5, 6]
ANCHOR_SCALE = [4.0, 4.0, 4.0, 4.0, 4.0, 4.0, 4.0, 5.0, 4.0]
INPUT_SIZES = [512, 640, 768, 896, 1024, 1280, 1280, 1536, 1536]

DEFAULT_MEAN = (0.485, 0.456, 0.406)
DEFAULT_STD = (0.229, 0.224, 0.225)

BACKBONES = efficientnet.BACKBONES + maxvit.BACKBONES


def feature_channels(backbone: str) -> List[int]:
    """Channels of the backbone's [P1..P5]."""
    if backbone in maxvit.TABLES:
        return maxvit.feature_channels(backbone)
    return efficientnet.feature_channels(backbone)


@dataclass(frozen=True)
class EfficientSegConfig:
    num_classes: int = 8
    compound_coef: int = 0
    scales: Tuple[float, ...] = (2 ** 0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0))
    ratios: Tuple[Tuple[float, float], ...] = ((1.0, 1.0), (1.4, 0.7), (0.7, 1.4))
    compute_dtype: torch.dtype = torch.float32
    mean: Tuple[float, ...] = DEFAULT_MEAN
    std: Tuple[float, ...] = DEFAULT_STD
    drop_connect_rate: float = 0.2      # backbone stochastic depth, training only
    remat: bool = False                 # recompute backbone and decoder activations in backward
    quant: str = "none"                 # "none" | "int8": int8 dense convs outside training
    backbone: Optional[str] = None      # None: EfficientNet-B<BACKBONE_COEF[compound_coef]>

    def __post_init__(self):
        if not 0 <= self.compound_coef <= 8:
            raise ValueError(f"compound_coef {self.compound_coef}: 0..8")
        if self.quant not in ("none", "int8"):
            raise ValueError(f"quant {self.quant!r}: 'none' or 'int8'")
        if self.backbone is not None and self.backbone not in BACKBONES:
            raise ValueError(f"unknown backbone {self.backbone!r}: one of {', '.join(BACKBONES)}")
        if self.quant == "int8" and self.backbone in maxvit.TABLES:
            raise ValueError(f"{self.backbone} has no int8 path: its attention and MLP layers "
                             "have no quantized form")

    @property
    def backbone_name(self) -> str:
        """The backbone built: ``backbone``, or the coefficient's B-series."""
        if self.backbone is None:
            return f"efficientnet-b{BACKBONE_COEF[self.compound_coef]}"
        return self.backbone

    @property
    def num_anchors(self) -> int:
        return len(self.scales) * len(self.ratios)

    @property
    def pyramid_levels(self) -> Tuple[int, ...]:
        return tuple(range(3, 3 + PYRAMID_LEVELS[self.compound_coef]))

    @property
    def anchor_scale(self) -> float:
        return ANCHOR_SCALE[self.compound_coef]


@contextlib.contextmanager
def _as_in_forward(module: nn.Module, generator: Optional[torch.Generator],
                   state: Optional[torch.Tensor]):
    """The recompute of a checkpointed segment: ``generator`` (if any) rewound
    to ``state``, its state when the forward ran the segment, and restored
    afterwards; ``module``'s buffers (the batch-norm running statistics, which
    the forward already updated once) put back as they were before the
    recompute, as flax's remat keeps only the forward's update."""
    buffers = [(b, b.clone()) for b in module.buffers()]
    now = None if generator is None else generator.get_state()
    if generator is not None:
        generator.set_state(state)
    try:
        yield
    finally:
        with torch.no_grad():
            for b, saved in buffers:
                b.copy_(saved)
        if generator is not None:
            generator.set_state(now)


def _remat(module: nn.Module, *args, generator: Optional[torch.Generator] = None):
    """``module(*args)`` under non-reentrant activation checkpointing, its
    recompute run as ``_as_in_forward`` says."""
    state = None if generator is None else generator.get_state()
    return checkpoint(module, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _as_in_forward(module, generator, state)))


class EfficientSeg(nn.Module):
    """Built on the CPU in float32 with default (untrained) values; conv
    weights are then held in ``param_dtype`` (default ``cfg.compute_dtype``,
    as serving wants; training passes float32 for master weights) and cast
    to ``cfg.compute_dtype`` per call. Fill it with
    ``weights.load_flax_variables`` or ``weights.init_random`` and move it
    with ``.to(device)``. It starts in eval mode."""

    def __init__(self, cfg: EfficientSegConfig, param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        coef = cfg.compound_coef
        chans = feature_channels(cfg.backbone_name)
        fpn_ch = FPN_FILTERS[coef]
        levels = PYRAMID_LEVELS[coef]
        quant = cfg.quant == "int8"
        name = cfg.backbone_name
        self.backbone_net = nn.ModuleDict({"model": (
            maxvit.MaxViTFeatures(name, cfg.drop_connect_rate) if name in maxvit.TABLES
            else EfficientNetFeatures(name, cfg.drop_connect_rate, quant))})
        self.bifpn = BiFPN(fpn_ch, chans[2:5], FPN_REPEATS[coef], attention=coef < 6,
                           use_p8=coef > 7)
        self.regressor = Regressor(fpn_ch, cfg.num_anchors, BOX_CLASS_REPEATS[coef],
                                   levels)
        self.classifier = Classifier(fpn_ch, cfg.num_anchors, cfg.num_classes,
                                     BOX_CLASS_REPEATS[coef], levels)
        self.kp_header = UNetDecoder(chans, quant=quant)
        self.register_buffer("pixel_mean", torch.tensor(cfg.mean) * 255.0,
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg.std) * 255.0,
                             persistent=False)
        cast_convs(self, param_dtype or cfg.compute_dtype)
        for name, m in self.named_modules():
            if isinstance(m, (Conv2d, Conv2dSame)):
                m.layer_name = name         # for the W-split path's errors
        self.eval()

    def input_tensor(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 [B, H, W, 3] frames -> the normalised [B, 3, H, W] input in
        the compute dtype, which the backbone and the U-Net take."""
        x = (images.float() - self.pixel_mean) / self.pixel_std
        return x.to(self.cfg.compute_dtype).permute(0, 3, 1, 2)

    def forward(self, images: torch.Tensor):
        mesh = spatial.active()
        if mesh is not None:
            return self._forward_spatial(images, mesh)
        x = self.input_tensor(images)
        backbone = self.backbone_net["model"]
        remat = self.cfg.remat and self.training and torch.is_grad_enabled()
        if remat:
            blocks = _remat(backbone, x, generator=backbone.generator)
        else:
            blocks = backbone(x)
        feats = self.bifpn(blocks[2:5])
        regression = self.regressor(feats).float()
        classification = self.classifier(feats)
        heads = _remat(self.kp_header, x, blocks) if remat else self.kp_header(x, blocks)
        if self.training:
            kp, ae, tan = (tuple(t.unbind(1)) for t in heads)
            return kp[0], ae, tan, regression, classification
        kp, ae, tan = (t.permute(0, 2, 3, 1) for t in heads)
        return kp, ae, tan, regression, classification

    def _forward_spatial(self, images: torch.Tensor, mesh):
        """The eval forward of the whole frames from this rank's W slab
        ``images`` [B, H, W / S, 3] (see the module docstring)."""
        cfg = self.cfg
        if self.training or cfg.remat or cfg.quant != "none":
            raise ValueError("the spatial mesh axis serves the eval forward only: no training, "
                             f"remat or quant (training={self.training}, remat={cfg.remat}, "
                             f"quant={cfg.quant!r})")
        x = self.input_tensor(images)
        blocks = self.backbone_net["model"](x)
        pyramid = [pin_data_sharding(b) for b in blocks[2:5]]
        with spatial.sharded(None):             # the pyramid and box heads: whole, replicated
            feats = self.bifpn(pyramid)
            regression = self.regressor(feats).float()
            classification = self.classifier(feats)
        heads = self.kp_header(x, blocks)
        dense = spatial.gather_w(torch.cat(heads, dim=1), mesh)
        kp, ae, tan = (t.permute(0, 2, 3, 1) for t in dense.split([t.shape[1] for t in heads], 1))
        return kp, ae, tan, regression, classification
