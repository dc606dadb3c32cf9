"""The trainer: trainable / frozen split, train and eval steps.

Counterpart of ``slam_llm_tpu/train/state.py``. The reference jits one
function (forward in bf16, f32 loss, backward with respect to the trainable
subtree, the optimizer); the port runs the same steps eagerly on the model's
parameters. ``state_from_params`` prepares a materialized model as the
reference's does:

* the int8 base gets its backward buffers derived, never trusted (the
  ``int8_rot`` pair, the ``int8_sr`` / ``int8`` transpose), and a
  ``ce_quant`` model its int8 CE head (``ops.quant.quantize_base_params``);
* ``requires_grad`` follows ``train.optimizer.param_label``; trainable
  tensors are f32 masters and frozen f32 parameters are stored in
  ``train_config.frozen_dtype`` (bf16 by default). The int8 scales are
  buffers and keep f32, ``kernel_scale_r`` included (the reference rounds
  that one to bf16). Frozen dense, conv and embedding weights are stored in
  the compute dtype whatever ``frozen_dtype`` says: every use casts them to
  it, so an f32 copy would give the same numbers.

One ``torch.Generator`` seeded from ``train_config.seed`` draws, on every
step (every micro-step under accumulation), a fresh uint32 seed per dense
whose dy quantization rounds stochastically and one for the int8_sr CE
head (the reference's ``quant`` rng stream); another drives LoRA dropout.
Neither is saved with the state: a resumed run restarts both from the seed,
as the reference's loop restarts its key.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

from slam_llm_tpu_torch.ops.quant import SR_MODES, quantize_base_params
from slam_llm_tpu_torch.train.optimizer import global_norm, lr_schedule, make_optimizer, partition_params


class Trainer:
    def __init__(self, model: nn.Module, slam_cfg, train_config):
        tc = train_config
        frozen_dtype = getattr(tc, "frozen_dtype", "bfloat16")
        if frozen_dtype not in (None, "float32", "fp32", "bfloat16", "bf16"):
            raise ValueError(f"train_config.frozen_dtype={frozen_dtype!r}: expected bfloat16 or float32")
        self.frozen_f32 = frozen_dtype in (None, "float32", "fp32")
        self.model, self.slam_cfg, self.train_config = model, slam_cfg, tc
        self.sched = lr_schedule(tc)
        self.accum = max(1, tc.gradient_accumulation_steps)
        self.device = next(model.parameters()).device
        self.use_dropout = bool(tc.use_peft and tc.peft_config.lora_dropout > 0)
        self.dropout_generator = torch.Generator(device=self.device).manual_seed(tc.seed)
        self.quant_generator = torch.Generator().manual_seed(tc.seed)
        self.sr_modules = [m for m in model.modules() if getattr(m, "quant", None) == "int8"
                           and m.quant_bwd in SR_MODES]
        self.ce_sr = slam_cfg.llm.ce_quant == "int8_sr"
        self.trainable: Dict[str, nn.Parameter] = {}
        self.frozen: Dict[str, nn.Parameter] = {}
        self.optimizer = None
        self.step = 0

    @torch.no_grad()
    def state_from_params(self) -> "Trainer":
        """Derive the int8 backward buffers and the int8 CE head, split and
        re-store the parameters, and build the optimizer over the trainable
        ones."""
        model, cfg = self.model, self.slam_cfg
        if cfg.llm.base_quant != "none" and not cfg.freeze_llm:
            raise ValueError(
                "llm.base_quant requires freeze_llm: the int8 dot's weight gradient is zero by "
                "construction, so training the base through it would silently not train"
            )
        self.trainable, self.frozen = partition_params(model, cfg)
        for p in self.trainable.values():
            p.data = p.data.float()
        if not self.frozen_f32:
            for p in self.frozen.values():
                if p.dtype == torch.float32:
                    p.data = p.data.to(torch.bfloat16)
        if cfg.llm.base_quant != "none" or cfg.llm.ce_quant != "none":
            quantize_base_params(model)
        for mod in model.modules():
            if getattr(mod, "lora_dropout", 0.0) > 0:
                mod.generator = self.dropout_generator
        self.optimizer = make_optimizer(list(self.trainable.values()), self.sched, self.train_config)
        return self

    def put_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """Host batch (numpy) -> tensors on the model's device."""
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items() if isinstance(v, np.ndarray)}

    def draw_quant_seeds(self) -> List[int]:
        """A fresh uint32 per stochastically rounding dense, then one for the
        int8_sr CE head, set on the modules."""
        n = len(self.sr_modules) + int(self.ce_sr)
        seeds = torch.randint(0, 2 ** 32, (n,), generator=self.quant_generator, dtype=torch.int64).tolist()
        self.set_quant_seeds(seeds)
        return seeds

    def set_quant_seeds(self, seeds: List[int]) -> None:
        """Put back seeds that ``draw_quant_seeds`` returned."""
        for mod, seed in zip(self.sr_modules, seeds):
            mod.quant_seed = seed
        if self.ce_sr:
            self.model.llm.ce_seed = seeds[-1]

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One micro-step: forward, backward and the optimizer (which moves
        the parameters on every ``gradient_accumulation_steps``-th call).
        Returns loss, acc, the lr of the current update and this micro-step's
        global gradient norm (tensors stay on the device; lr is a float)."""
        self.draw_quant_seeds()
        self.model.train(self.use_dropout)
        out = self.model(batch)
        params = list(self.trainable.values())
        grads = torch.autograd.grad(out["loss"], params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        lr = self.sched(self.step // self.accum)  # the reference logs the inner update's lr
        self.optimizer.step(grads)
        self.step += 1
        return {"loss": out["loss"].detach(), "acc": out["acc"], "lr": lr, "grad_norm": global_norm(grads)}

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.model.eval()
        out = self.model(batch)
        return {"loss": out["loss"], "acc": out["acc"]}

    def state_dict(self) -> Dict:
        """The reference's full state: trainable tensors, optimizer state and
        step (no generator state)."""
        return {"trainable": {n: p.detach().cpu() for n, p in self.trainable.items()},
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        if set(state["trainable"]) != set(self.trainable):
            raise ValueError("the full state's trainable tensors do not match this model's")
        for name, p in self.trainable.items():
            p.copy_(state["trainable"][name])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
