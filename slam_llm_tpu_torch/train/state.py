"""The trainer: trainable / frozen split, train and eval steps.

Counterpart of ``slam_llm_tpu/train/state.py``. The reference jits one
function (forward in bf16, f32 loss, backward with respect to the trainable
subtree, AdamW); the port runs the same steps eagerly on the model's
parameters. ``state_from_params`` prepares a materialized model as the
reference's does:

* the int8 base gets its ``int8_rot`` pair derived, never trusted
  (``ops.quant.quantize_base_params``);
* ``requires_grad`` follows ``train.optimizer.param_label``; trainable
  tensors are f32 masters and frozen f32 parameters are stored in bf16 (the
  reference's ``frozen_dtype``). The int8 scales are buffers and keep f32,
  ``kernel_scale_r`` included (the reference rounds that one to bf16).

One ``torch.Generator`` seeded from ``train_config.seed`` draws a fresh
uint32 seed per ``int8_rot`` dense per step for the stochastic rounding of
its dy (the reference's ``quant`` rng stream); another drives LoRA dropout.
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from slam_llm_tpu_torch.ops.quant import quantize_base_params
from slam_llm_tpu_torch.train.optimizer import AdamW, lr_schedule, partition_params

_log = logging.getLogger("slam_llm_tpu_torch")
_TODO = "is not ported yet (ROADMAP Queue 1)"


class Trainer:
    def __init__(self, model: nn.Module, slam_cfg, train_config):
        tc = train_config
        if getattr(tc, "optimizer", "adamw") != "adamw":
            raise NotImplementedError(f"optimizer {tc.optimizer!r} {_TODO}")
        if tc.gradient_accumulation_steps > 1:
            raise NotImplementedError(f"gradient_accumulation_steps > 1 {_TODO}")
        self.model, self.slam_cfg, self.train_config = model, slam_cfg, tc
        self.sched = lr_schedule(tc)
        self.device = next(model.parameters()).device
        self.use_dropout = bool(tc.use_peft and tc.peft_config.lora_dropout > 0)
        self.dropout_generator = torch.Generator(device=self.device).manual_seed(tc.seed)
        self.quant_generator = torch.Generator().manual_seed(tc.seed)
        self.rot_modules = [m for m in model.modules() if getattr(m, "kernel_qr", None) is not None]
        self.trainable: Dict[str, nn.Parameter] = {}
        self.frozen: Dict[str, nn.Parameter] = {}
        self.optimizer = None
        self.step = 0
        if slam_cfg.llm.remat:
            _log.info("remat=%s (%s): activation checkpointing is not applied yet; every activation "
                      "is kept (same numbers, more memory)", slam_cfg.llm.remat, slam_cfg.llm.remat_policy)

    @torch.no_grad()
    def state_from_params(self) -> "Trainer":
        """Derive the int8_rot pairs, split and re-store the parameters, and
        build the optimizer over the trainable ones."""
        model, cfg = self.model, self.slam_cfg
        if cfg.llm.base_quant != "none":
            if not cfg.freeze_llm:
                raise ValueError(
                    "llm.base_quant requires freeze_llm: the int8 dot's weight gradient is zero by "
                    "construction, so training the base through it would silently not train"
                )
            quantize_base_params(model)
        self.trainable, self.frozen = partition_params(model, cfg)
        for p in self.trainable.values():
            p.data = p.data.float()
        for p in self.frozen.values():
            if p.dtype == torch.float32:
                p.data = p.data.to(torch.bfloat16)
        for mod in model.modules():
            if getattr(mod, "lora_dropout", 0.0) > 0:
                mod.generator = self.dropout_generator
        self.optimizer = AdamW(list(self.trainable.values()), self.sched,
                               weight_decay=self.train_config.weight_decay)
        return self

    def put_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """Host batch (numpy) -> tensors on the model's device."""
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items() if isinstance(v, np.ndarray)}

    def draw_quant_seeds(self) -> List[int]:
        """A fresh uint32 per int8_rot dense, set on the modules."""
        seeds = torch.randint(0, 2 ** 32, (len(self.rot_modules),), generator=self.quant_generator,
                              dtype=torch.int64).tolist()
        for mod, seed in zip(self.rot_modules, seeds):
            mod.quant_seed = seed
        return seeds

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimizer step; returns loss, acc, lr and the pre-clip global
        gradient norm (tensors stay on the device; lr is a float)."""
        self.draw_quant_seeds()
        self.model.train(self.use_dropout)
        out = self.model(batch)
        params = list(self.trainable.values())
        grads = torch.autograd.grad(out["loss"], params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        lr, grad_norm = self.optimizer.step(grads)
        self.step += 1
        return {"loss": out["loss"].detach(), "acc": out["acc"], "lr": lr, "grad_norm": grad_norm}

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.model.eval()
        out = self.model(batch)
        return {"loss": out["loss"], "acc": out["acc"]}
