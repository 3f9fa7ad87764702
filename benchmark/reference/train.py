"""The reference training step: targets, train-mode forward in float32,
the five losses, backward, and Adam with the L2 term, written out.

``Trainer`` has the port's step interface (``step(images, polys, n_verts,
cls_ids)`` returning the loss stats; ``model``; ``optimizer.state[p]
["exp_avg"]``), so it can stand in the program's place, in float8 for the
lower-precision control (``fp8``). The optimizer is the reference's
``optax.chain(add_decayed_weights(1e-4), adam(lr, 0.9, 0.999, eps=1e-8))``:
the decay term is added to the gradient before the moments. Drop-connect
draws its masks from a generator on the device seeded with ``drop_seed``,
in the order the forward meets the blocks.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from benchmark.reference.anchors import generate_anchors
from benchmark.reference.efficientseg import EfficientSeg, EfficientSegConfig
from benchmark.reference.layers import set_fp8
from benchmark.reference.losses import LossConfig, compose_loss
from benchmark.reference.targets import generate_targets
from benchmark.reference.weights import load_flax_variables


class Adam:
    """Adam with the decay added to the gradient (torch's ``Adam`` with
    ``weight_decay``, optax's chain above), state as ``torch.optim`` keeps it."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        self.params = list(params)
        self.lr, self.betas, self.eps, self.weight_decay = lr, betas, eps, weight_decay
        self.state = {p: {"step": 0, "exp_avg": torch.zeros_like(p),
                          "exp_avg_sq": torch.zeros_like(p)} for p in self.params}

    @torch.no_grad()
    def step(self) -> None:
        b1, b2 = self.betas
        for p in self.params:
            if p.grad is None:
                continue
            s = self.state[p]
            s["step"] += 1
            g = p.grad + self.weight_decay * p
            s["exp_avg"].mul_(b1).add_(g, alpha=1 - b1)
            s["exp_avg_sq"].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = s["exp_avg"] / (1 - b1 ** s["step"])
            v_hat = s["exp_avg_sq"] / (1 - b2 ** s["step"])
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


class Trainer:
    def __init__(self, cfg: EfficientSegConfig, weights: Mapping, input_hw: Tuple[int, int],
                 max_points: int, lr: float, device: torch.device, drop_seed: int,
                 fp8: bool = False):
        self.device, self.input_hw, self.max_points = device, tuple(input_hw), max_points
        model = EfficientSeg(cfg, param_dtype=torch.float32)
        load_flax_variables(model, weights)
        self.model = model.to(device).train()
        if fp8:
            set_fp8(self.model)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(drop_seed)
        self.model.backbone_net["model"].generator = self.generator
        self.optimizer = Adam(self.model.parameters(), lr)
        self.anchors = torch.tensor(generate_anchors(
            *self.input_hw, pyramid_levels=cfg.pyramid_levels, anchor_scale=cfg.anchor_scale,
            scales=cfg.scales, ratios=cfg.ratios), device=device)

    def step(self, images, polys, n_verts, cls_ids) -> Dict[str, torch.Tensor]:
        dev = self.device
        images = torch.as_tensor(images).to(dev)
        polys = torch.as_tensor(polys, dtype=torch.float32).to(dev)
        n_verts = torch.as_tensor(n_verts).to(dev, torch.int32)
        cls_ids = torch.as_tensor(cls_ids).to(dev, torch.int32)
        targets = generate_targets(polys, n_verts, cls_ids, *self.input_hw,
                                   max_points=self.max_points, dense_kp=False)
        self.optimizer.zero_grad()
        total, stats = compose_loss(self.model(images), targets, self.anchors, LossConfig())
        total.backward()
        self.optimizer.step()
        return {k: v.detach() for k, v in stats.items()}
