"""The trainer: trainable / frozen split, train and eval steps.

Counterpart of ``slam_llm_tpu/train/state.py``. The reference jits one
function (forward in bf16, f32 loss, backward with respect to the trainable
subtree, the optimizer); the port runs the same steps eagerly on the model's
parameters. ``state_from_params`` prepares a materialized model as the
reference's does:

* the int8 base gets its backward buffers derived, never trusted (the
  ``int8_rot`` pair, the ``int8_sr`` / ``int8`` transpose), and a
  ``ce_quant`` model its int8 CE head (``ops.quant.quantize_base_params``);
  a ``bwd_pretranspose`` model its ``kernel_t`` copies
  (``models.layers.refresh_pretransposed``, from each tp rank's own shard);
* ``requires_grad`` follows ``train.optimizer.param_label`` (an S2S model's
  ``train_audio_embed_only`` also masks the head's updates to the audio
  vocabulary, ``train.optimizer.partial_embed_grad_mask``); trainable
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

With a ``mesh`` (``parallel.make_mesh``; one process per card) the trainer
runs the reference's sharded step: ``state_from_params`` derives the int8
tensors on the whole model and then shards it (``parallel.shard_params``:
FSDP2 over ``("dp", "fsdp")``); ``put_batch`` keeps the rank's rows of the
global batch; the forward divides each rank's NLL sum by the global batch's
token count, so the ranks' losses sum to the reference's mean and FSDP2's
summed reduce-scatter leaves each rank the gradient of the global loss on
its shards; the optimizer updates the local shards, its clip reading the
global norm (a sum of squares all-reduced over ``fsdp``). The logged loss
and accuracy are the global batch's. ``state_dict`` gathers whole tensors
(every rank joins) and ``load_state_dict`` takes whole tensors, so a state
moves between world sizes. Each data rank's LoRA dropout and stochastic-
rounding seeds are offset by its rank (rank 0 keeps the one-process
streams): a rank quantizes its own rows, whose row indices restart at 0.

Under tensor parallelism (``tp`` > 1) ``shard_params`` first splits the
decoder LLM over tp (``parallel.tensor_parallel``); the tp ranks of one data
rank take the same rows, draw the same dropout masks and seeds (both keyed
on the data rank) and hold one layer's shards each. The loss sums and
metrics reduce over the data ranks only (``parallel.sharding.data_group``),
the norm over the fsdp and tp ranks with each tp-replicated tensor counted
once (``NormGroups``), and the whole tensors of a checkpoint are gathered
over FSDP, then over tp (``ShardLayout``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from slam_llm_tpu_torch.models.layers import refresh_pretransposed
from slam_llm_tpu_torch.ops.quant import SR_MODES, quantize_base_params
from slam_llm_tpu_torch.parallel.sharding import (
    ShardLayout,
    all_reduce_sum,
    data_group,
    data_rank,
    global_loss,
    local_part,
    norm_groups,
    shard_batch,
    shard_params,
)
from slam_llm_tpu_torch.parallel.tensor_parallel import split_dim, tp_dim, tp_of
from slam_llm_tpu_torch.train.optimizer import (
    global_norm,
    lr_schedule,
    make_optimizer,
    partial_embed_grad_mask,
    partition_params,
)


_SEED_STRIDE = 0x9E3779B9  # a data rank's offset of the stochastic-rounding seeds


def frozen_in_f32(train_config) -> bool:
    """Whether ``train_config.frozen_dtype`` keeps frozen f32 parameters in
    f32 (else bf16); another value raises."""
    frozen_dtype = getattr(train_config, "frozen_dtype", "bfloat16")
    if frozen_dtype not in (None, "float32", "fp32", "bfloat16", "bf16"):
        raise ValueError(f"train_config.frozen_dtype={frozen_dtype!r}: expected bfloat16 or float32")
    return frozen_dtype in (None, "float32", "fp32")


def derives_int8(slam_cfg) -> bool:
    """Whether the trainer derives the int8 base's backward tensors or the
    int8 CE head (``ops.quant.quantize_base_params``)."""
    llm = getattr(slam_cfg, "llm", None)  # VALL-E X's config has none: every VALLE tensor trains
    return getattr(llm, "base_quant", "none") != "none" or getattr(llm, "ce_quant", "none") != "none"


@torch.no_grad()
def prepare_params(model: nn.Module, slam_cfg, train_config):
    """The trainer's checks, ``requires_grad`` by ``param_label``, the f32
    master of every trainable tensor and ``frozen_dtype`` on the frozen f32
    ones, in place (values, or dtypes alone on a model on ``meta``).
    Returns (trainable, frozen)."""
    llm = getattr(slam_cfg, "llm", None)
    if getattr(llm, "base_quant", "none") != "none" and not slam_cfg.freeze_llm:
        raise ValueError(
            "llm.base_quant requires freeze_llm: the int8 dot's weight gradient is zero by "
            "construction, so training the base through it would silently not train"
        )
    if getattr(llm, "bwd_pretranspose", False) and not slam_cfg.freeze_llm:
        raise ValueError(
            "llm.bwd_pretranspose requires freeze_llm: training the base "
            "kernels would silently desynchronize their kernel_t copies"
        )
    trainable, frozen = partition_params(model, slam_cfg)
    for p in trainable.values():
        p.data = p.data.float()
    if not frozen_in_f32(train_config):
        for p in frozen.values():
            if p.dtype == torch.float32:
                p.data = p.data.to(torch.bfloat16)
    return trainable, frozen


class Trainer:
    def __init__(self, model: nn.Module, slam_cfg, train_config, mesh=None):
        tc = train_config
        self.frozen_f32 = frozen_in_f32(tc)
        self.model, self.slam_cfg, self.train_config = model, slam_cfg, tc
        self.sched = lr_schedule(tc)
        self.accum = max(1, tc.gradient_accumulation_steps)
        self.device = next(model.parameters()).device
        self.mesh = mesh
        self.rank = data_rank(mesh) if mesh is not None else 0
        # the ranks a batch is split over (loss sums) and those a parameter
        # is sharded over (norm sums; set with the layout)
        self.data_group = data_group(mesh) if mesh is not None else None
        self.norm_group = None
        self.layout = None  # parallel.sharding.ShardLayout of the trainable tensors, under a mesh
        self.use_dropout = bool(tc.use_peft and tc.peft_config.lora_dropout > 0)
        self.dropout_generator = torch.Generator(device=self.device).manual_seed(tc.seed + self.rank)
        self.quant_generator = torch.Generator().manual_seed(tc.seed)
        self.sr_modules = [m for m in model.modules() if getattr(m, "quant", None) == "int8"
                           and m.quant_bwd in SR_MODES]
        self.ce_sr = getattr(getattr(slam_cfg, "llm", None), "ce_quant", "none") == "int8_sr"
        self.trainable: Dict[str, nn.Parameter] = {}
        self.frozen: Dict[str, nn.Parameter] = {}
        self.optimizer = None
        self.step = 0

    @torch.no_grad()
    def state_from_params(self) -> "Trainer":
        """Derive the int8 backward buffers and the int8 CE head, split and
        re-store the parameters, shard them over the mesh (when there is
        one), and build the optimizer over the trainable ones (their local
        shards)."""
        model, cfg = self.model, self.slam_cfg
        built = getattr(model, "sharded_build", False)  # pipeline.common built it into its shards
        if not built:
            self.trainable, self.frozen = prepare_params(model, cfg, self.train_config)
            if derives_int8(cfg):
                quantize_base_params(model)
        for mod in model.modules():
            if getattr(mod, "lora_dropout", 0.0) > 0:
                mod.generator = self.dropout_generator
        if self.mesh is None:
            refresh_pretransposed(model)
        else:  # derives kernel_t after the tp split
            if not built:
                shard_params(model, self.mesh)
            self.trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
            self.frozen = {n: p for n, p in model.named_parameters() if not p.requires_grad}
        params = list(self.trainable.values())
        self.optimizer = make_optimizer([local_part(p) for p in params], self.sched, self.train_config)
        inner = getattr(self.optimizer, "inner", self.optimizer)
        if self.mesh is not None:
            self.layout = ShardLayout(params, [tp_dim(model, n) for n in self.trainable], tp_of(self.mesh))
            self.norm_group = norm_groups(self.mesh, self.layout)
            inner.layout = self.layout
            if inner is not self.optimizer:
                self.optimizer.layout = inner.layout
        inner.norm_group = self.norm_group
        if getattr(cfg, "train_audio_embed_only", False):
            # S2S: the head's updates kept to the extended audio vocabulary (the rank's rows of it)
            v = cfg.vocab
            masks = partial_embed_grad_mask(self._whole_shapes(), v.padded_text_vocabsize, v.total_vocabsize)
            inner.update_masks = [None if name not in masks else self._local(i, masks[name].to(self.device))
                                  for i, name in enumerate(self.trainable)]
        return self

    def _whole_shapes(self) -> Dict[str, torch.Tensor]:
        """Stand-ins of the trainable tensors' whole shapes (one element each)."""
        out = {}
        for i, (name, p) in enumerate(self.trainable.items()):
            shape = list(p.shape)  # a DTensor's is whole over FSDP
            dim = None if self.layout is None else self.layout.tp_dims[i]
            if dim is not None and self.layout.tp is not None:
                shape[split_dim(dim)] *= self.layout.tp.size
            out[name] = torch.zeros((), device=self.device).expand(shape)
        return out

    def _local(self, i: int, whole: torch.Tensor) -> torch.Tensor:
        """This rank's part of trainable tensor ``i``'s whole value."""
        return whole if self.layout is None else self.layout.local(i, whole)

    def _global_loss(self):
        """Loss denominators over the global batch (``parallel.sharding.token_count``)."""
        return global_loss(self.data_group) if self.mesh is not None else contextlib.nullcontext()

    def _global_metrics(self, loss: torch.Tensor, acc: torch.Tensor):
        """The global batch's loss and accuracy: the sum of the ranks' shares."""
        if self.mesh is None:
            return loss, acc
        return tuple(all_reduce_sum([loss, acc], self.data_group))

    def put_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """Host batch (numpy) -> tensors on the model's device; with a mesh,
        this rank's rows of it (``parallel.shard_batch``)."""
        if self.mesh is not None:
            batch = shard_batch(self.mesh, batch)
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items() if isinstance(v, np.ndarray)}

    def draw_quant_seeds(self) -> List[int]:
        """A fresh uint32 per stochastically rounding dense, then one for the
        int8_sr CE head, set on the modules."""
        n = len(self.sr_modules) + int(self.ce_sr)
        seeds = torch.randint(0, 2 ** 32, (n,), generator=self.quant_generator, dtype=torch.int64).tolist()
        seeds = [(s + self.rank * _SEED_STRIDE) % 2 ** 32 for s in seeds]
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
        global gradient norm (tensors stay on the device; lr is a float).
        The backward accumulates into ``.grad`` (FSDP2 reduce-scatters from
        there), which is read (the local shard) and cleared."""
        self.draw_quant_seeds()
        self.model.train(self.use_dropout)
        with self._global_loss():
            out = self.model(batch)
        out["loss"].backward()
        params = list(self.trainable.values())
        grads = [torch.zeros_like(local_part(p)) if p.grad is None else local_part(p.grad) for p in params]
        for p in params:
            p.grad = None
        lr = self.sched(self.step // self.accum)  # the reference logs the inner update's lr
        self.optimizer.step(grads)
        self.step += 1
        loss, acc = self._global_metrics(out["loss"].detach(), out["acc"])
        return {"loss": loss, "acc": acc, "lr": lr, "grad_norm": global_norm(grads, self.norm_group)}

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The global batch's loss and accuracy."""
        self.model.eval()
        with self._global_loss():
            out = self.model(batch)
        loss, acc = self._global_metrics(out["loss"], out["acc"])
        return {"loss": loss, "acc": acc}

    def whole_trainable(self) -> Dict[str, torch.Tensor]:
        """The trainable tensors whole, on the CPU (gathered: every rank joins)."""
        if self.layout is None:
            return {n: p.detach().cpu() for n, p in self.trainable.items()}
        return {n: self.layout.whole(i, local_part(p.detach())).cpu()
                for i, (n, p) in enumerate(self.trainable.items())}

    def state_dict(self) -> Dict:
        """The reference's full state: trainable tensors, optimizer state and
        step (no generator state), all whole (every rank joins)."""
        return {"trainable": self.whole_trainable(), "optimizer": self.optimizer.state_dict(), "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """A full state of whole tensors (saved at any world size)."""
        if set(state["trainable"]) != set(self.trainable):
            raise ValueError("the full state's trainable tensors do not match this model's")
        for i, (name, p) in enumerate(self.trainable.items()):
            local_part(p).copy_(self._local(i, state["trainable"][name]))
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
