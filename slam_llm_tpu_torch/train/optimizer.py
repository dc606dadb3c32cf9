"""Trainable / frozen parameter split, learning-rate schedule and AdamW.

Counterpart of ``slam_llm_tpu/train/optimizer.py``. The reference splits
its parameter tree into (trainable, frozen) subtrees and differentiates the
loss with respect to the trainable one; the port marks the same parameters
``requires_grad`` and differentiates with respect to them. The optimizer is
the reference's ``clip_by_global_norm(1.0)`` then optax ``adamw``, or the
reference's ``anyprecision_adamw`` (bf16 moments, Kahan-compensated
updates), written out in f32 with the reference's operation order; the
schedule evaluates in f32 like optax's. ``gradient_accumulation_steps > 1``
wraps either in ``MultiSteps`` (optax's). ``state_dict`` / ``load_state_dict``
carry the full optimizer state for ``save_optimizer`` / ``resume_from``.

Under FSDP2 (``train.state.Trainer`` with a mesh) the optimizer holds the
local shards of the parameters and gets their local gradients: the clip's
global norm sums the squares over the local shards and all-reduces the sum
over ``norm_group`` (the ``fsdp`` ranks; ``dp`` replicas hold the same
shards; under tp also the tp ranks, ``parallel.sharding.NormGroups``), and
``layout`` (``parallel.sharding.ShardLayout``) gathers the
state whole for saving and takes a whole one apart on loading.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


# prefix-tuning's key / value slots, llama-adapter's prompt and gate
_PEFT_LEAVES = ("prefix_k", "prefix_v", "adaption_prompt", "adaption_gate")


def param_label(name: str, slam_cfg) -> str:
    """'train' or 'freeze' for a parameter name (``model.named_parameters``):
    the projector, the LoRA factors and the prefix / adapter tensors train; the encoder freezes iff
    ``freeze_encoder``, the LLM iff ``freeze_llm``; anything else trains.
    The S2S tricks (the reference's trick_utils.py): ``train_embed_only`` /
    ``train_audio_embed_only`` train the ``lm_head`` alone,
    ``train_embed`` trains it besides the rest."""
    if getattr(slam_cfg, "train_embed_only", False) or getattr(slam_cfg, "train_audio_embed_only", False):
        return "train" if "lm_head" in name else "freeze"
    if getattr(slam_cfg, "train_embed", False) and "lm_head" in name:
        return "train"
    if "encoder_projector" in name:
        return "train"
    if "lora_a" in name or "lora_b" in name:
        return "train"
    if name.endswith(_PEFT_LEAVES):
        return "train"
    if name.startswith("encoder."):
        return "freeze" if slam_cfg.freeze_encoder else "train"
    if name.startswith("llm."):
        return "freeze" if slam_cfg.freeze_llm else "train"
    return "train"


def partial_embed_grad_mask(params: Dict[str, torch.Tensor], start: int, end: int) -> Dict[str, torch.Tensor]:
    """The JAX package's ``partial_embed_grad_mask`` (the reference's
    gradient-zeroing hook, trick_utils.py:14-18): for every 2-D ``lm_head``
    or embedding tensor with at least ``end`` vocabulary rows, a (V, 1) f32
    mask that keeps the updates of rows [start, end) and zeroes the rest
    (the port stores both as (V, D)). A narrower head (group decode's) gets
    none, as in the JAX package."""
    masks = {}
    for name, p in params.items():
        if p.ndim == 2 and ("lm_head" in name or "embed_tokens" in name) and p.shape[0] >= end:
            rows = torch.arange(p.shape[0], device=p.device)
            masks[name] = ((rows >= start) & (rows < end)).float()[:, None]
    return masks


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


def global_norm(grads: Sequence[torch.Tensor], group=None) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every entry's square, in f32;
    with ``group``, of the local shards' sums all-reduced over it (a
    ``parallel.sharding.NormGroups`` under tensor parallelism: the fsdp and
    tp ranks, each tp-replicated tensor counted once)."""
    if hasattr(group, "square_sum"):
        return torch.sqrt(group.square_sum(grads))
    sq = sum(g.float().square().sum() for g in grads)
    if group is not None:
        sq = sq.clone()
        dist.all_reduce(sq, group=group)
    return torch.sqrt(sq)


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
        # per parameter, None or a mask the update is multiplied by (optax's
        # chain(tx, partial_embed_grad_mask)); set by the trainer
        self.update_masks: List = [None] * len(self.params)
        self.norm_group = None  # set by a sharded trainer
        self.layout = None

    def _clipped(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        grads = [g.float() for g in grads]
        norm = global_norm(grads, self.norm_group)
        clip = norm >= self.max_grad_norm
        return [torch.where(clip, g / norm * self.max_grad_norm, g) for g in grads]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """Apply one update."""
        grads = self._clipped(grads)
        lr = self.sched(self.count)
        self.count += 1
        bc1 = float(1 - np.float32(self.b1) ** np.float32(self.count))
        bc2 = float(1 - np.float32(self.b2) ** np.float32(self.count))
        for p, g, mu, nu, mask in zip(self.params, grads, self.mu, self.nu, self.update_masks):
            mu.mul_(self.b1).add_(g * (1 - self.b1))
            nu.mul_(self.b2).add_(g * g * (1 - self.b2))
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                upd = upd + self.weight_decay * p.float()
            upd = upd * -lr
            p.add_((upd if mask is None else upd * mask).to(p.dtype))

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": _export(self.mu, self.layout), "nu": _export(self.nu, self.layout)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for key in ("mu", "nu"):
            _copy_list(getattr(self, key), state[key], key, self.layout)


class AnyPrecisionAdamW(AdamW):
    """The reference's ``anyprecision_adamw`` behind the same global-norm
    clip: ``mu`` and ``nu`` stored in bf16 and updated in f32; bias
    correction from the 1-based count; the learning rate at the
    pre-increment count; the update added with Kahan compensation kept in
    the parameter's dtype (``p + ((p + y) - p)``, the reference's
    ``p + delta``)."""

    def __init__(self, params: Sequence[torch.Tensor], sched: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0, max_grad_norm: float = 1.0):
        super().__init__(params, sched, b1, b2, eps, weight_decay, max_grad_norm)
        self.mu = [torch.zeros_like(p, dtype=torch.bfloat16) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.bfloat16) for p in self.params]
        self.compensation = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = self._clipped(grads)
        lr = self.sched(self.count)
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(self.count))
        for p, g, mu, nu, comp, mask in zip(self.params, grads, self.mu, self.nu, self.compensation,
                                            self.update_masks):
            mu32 = mu.float() * self.b1 + (1 - self.b1) * g
            nu32 = nu.float() * self.b2 + (1 - self.b2) * g * g
            # the divisions by a tensor stay true divisions on CUDA (see rowquant_ref)
            mu_hat = mu32 / mu32.new_full((), bc1)
            nu_hat = nu32 / nu32.new_full((), bc2)
            upd = mu_hat / (torch.sqrt(nu_hat) + self.eps) + self.weight_decay * p.float()
            upd = upd * -lr
            y = (upd if mask is None else upd * mask).to(p.dtype) + comp
            new_p = p + y
            comp.copy_((y - (new_p - p)).to(p.dtype))
            p.add_((new_p - p).to(p.dtype))
            mu.copy_(mu32)
            nu.copy_(nu32)

    def state_dict(self) -> Dict:
        return {**super().state_dict(), "compensation": _export(self.compensation, self.layout)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        super().load_state_dict(state)
        _copy_list(self.compensation, state["compensation"], "compensation", self.layout)


class MultiSteps:
    """optax ``MultiSteps``: gradients averaged in its running-mean order
    (``acc + (g - acc) / (n + 1)``), the inner optimizer applied on every
    k-th call and the parameters untouched in between; the inner count (so
    the schedule and the bias correction) advances once per k calls."""

    def __init__(self, inner: AdamW, k: int):
        self.inner, self.k = inner, k
        self.acc = [torch.zeros_like(p, dtype=torch.float32) for p in inner.params]
        self.mini_step = 0
        self.layout = None  # the inner optimizer's, set by a sharded trainer

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        n = self.mini_step
        for acc, g in zip(self.acc, grads):
            acc.add_((g.float() - acc) / acc.new_full((), n + 1))
        self.mini_step = (n + 1) % self.k
        if self.mini_step == 0:
            self.inner.step(self.acc)
            for acc in self.acc:
                acc.zero_()

    def state_dict(self) -> Dict:
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step, "acc": _export(self.acc, self.layout)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.mini_step = int(state["mini_step"])
        _copy_list(self.acc, state["acc"], "acc", self.layout)


def _export(tensors: Sequence[torch.Tensor], layout) -> List[torch.Tensor]:
    """Per-parameter state on the CPU, whole (gathered through ``layout``)."""
    return [(t if layout is None else layout.whole(i, t)).detach().cpu() for i, t in enumerate(tensors)]


def _copy_list(dst: List[torch.Tensor], src: Sequence[torch.Tensor], what: str, layout=None) -> None:
    if len(dst) == len(src) and layout is not None:
        src = [layout.local(i, s) for i, s in enumerate(src)]
    if len(dst) != len(src) or any(d.shape != s.shape or d.dtype != s.dtype for d, s in zip(dst, src)):
        raise ValueError(f"optimizer state {what!r} does not match the trainable tensors")
    for d, s in zip(dst, src):
        d.copy_(s)


def make_optimizer(params: Sequence[torch.Tensor], sched: Callable[[int], float], train_config):
    """The reference's ``make_optimizer``: AdamW or ``anyprecision`` behind
    the global-norm clip, in ``MultiSteps`` when accumulating."""
    tc = train_config
    name = getattr(tc, "optimizer", "adamw")
    if name not in ("adamw", "anyprecision"):
        raise ValueError(f"unknown optimizer {name!r}: expected adamw or anyprecision")
    cls = AnyPrecisionAdamW if name == "anyprecision" else AdamW
    opt = cls(params, sched, weight_decay=tc.weight_decay)
    return MultiSteps(opt, tc.gradient_accumulation_steps) if tc.gradient_accumulation_steps > 1 else opt
