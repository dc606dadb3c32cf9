"""Trainable / frozen parameter split, learning-rate schedule and AdamW.

Counterpart of ``slam_llm_tpu/train/optimizer.py``. The reference splits
its parameter tree into (trainable, frozen) subtrees and differentiates the
loss with respect to the trainable one; the port marks the same parameters
``requires_grad`` and differentiates with respect to them. The optimizer is
the reference's ``clip_by_global_norm(1.0)`` then optax ``adamw``, written
out in f32 with optax's operation order, and the schedule evaluates in f32
like optax's. ``optimizer: anyprecision`` and gradient accumulation are not
ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn


def param_label(name: str, slam_cfg) -> str:
    """'train' or 'freeze' for a parameter name (``model.named_parameters``):
    the projector and the LoRA factors train; the encoder freezes iff
    ``freeze_encoder``, the LLM iff ``freeze_llm``; anything else trains."""
    if "encoder_projector" in name:
        return "train"
    if "lora_a" in name or "lora_b" in name:
        return "train"
    if name.startswith("encoder."):
        return "freeze" if slam_cfg.freeze_encoder else "train"
    if name.startswith("llm."):
        return "freeze" if slam_cfg.freeze_llm else "train"
    return "train"


def partition_params(model: nn.Module, slam_cfg) -> Tuple[Dict[str, nn.Parameter], Dict[str, nn.Parameter]]:
    """Set ``requires_grad`` by ``param_label``; return (trainable, frozen)."""
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        train = param_label(name, slam_cfg) == "train"
        p.requires_grad_(train)
        (trainable if train else frozen)[name] = p
    return trainable, frozen


def count_params(params) -> int:
    values = params.values() if isinstance(params, dict) else params
    return sum(p.numel() for p in values)


def lr_schedule(train_config) -> Callable[[int], float]:
    """Linear warmup from 0 to ``lr`` over ``warmup_steps``, then linear
    decay to 10 % at ``total_steps``, evaluated at the optimizer's
    pre-increment count (step 0 has lr 0 under warmup). f32 arithmetic in
    optax's ``polynomial_schedule`` order."""
    tc = train_config
    warmup = max(1, tc.warmup_steps)
    total = max(tc.total_steps, warmup + 1)
    f32 = np.float32

    def linear(init: float, end: float, steps: int, count: int) -> float:
        frac = f32(1) - f32(min(max(count, 0), steps)) / f32(steps)
        return float(f32(init - end) * frac + f32(end))

    def sched(count: int) -> float:
        if count < warmup:
            return linear(0.0, tc.lr, warmup, count)
        return linear(tc.lr, tc.lr * 0.1, total - warmup, count - warmup)

    return sched


class AdamW:
    """``clip_by_global_norm(max_grad_norm)`` then AdamW (decoupled weight
    decay) over a list of f32 parameters, updated in place; optax's
    ``chain(clip_by_global_norm, adamw)`` with its operation order."""

    def __init__(self, params: Sequence[torch.Tensor], sched: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0, max_grad_norm: float = 1.0):
        self.params: List[torch.Tensor] = list(params)
        self.sched, self.b1, self.b2, self.eps = sched, b1, b2, eps
        self.weight_decay, self.max_grad_norm = weight_decay, max_grad_norm
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> Tuple[float, torch.Tensor]:
        """Apply one update; returns (lr of this step, pre-clip global norm)."""
        grads = [g.float() for g in grads]
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        clip = norm >= self.max_grad_norm
        lr = self.sched(self.count)
        self.count += 1
        bc1 = float(1 - np.float32(self.b1) ** np.float32(self.count))
        bc2 = float(1 - np.float32(self.b2) ** np.float32(self.count))
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = torch.where(clip, g / norm * self.max_grad_norm, g)
            mu.mul_(self.b1).add_(g * (1 - self.b1))
            nu.mul_(self.b2).add_(g * g * (1 - self.b2))
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                upd = upd + self.weight_decay * p.float()
            p.add_((upd * -lr).to(p.dtype))
        return lr, norm
