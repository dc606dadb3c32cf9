"""Tensor parallelism: a Megatron-style split of the decoder LLM, the whisper
encoder and the MLP projectors over ``tp``.

Counterpart of the JAX package's logical rules ``heads`` / ``kv_heads`` /
``mlp`` / ``vocab -> tp`` (``slam_llm_tpu/parallel/sharding.py``). There
GSPMD partitions every decoder product and inserts the collectives; with
hand-written kernels each rank runs K1 / K4 on its own heads and K3 on its
own weight shards, and the collectives are explicit:

* column-parallel denses (q / k / v, gate / up, the head): the weight split
  on its output features F; the input whole on every rank, the output this
  rank's columns. The input's gradient is reduced inside the dense: the int8
  base all-reduces its s32 accumulators (exact), a plain product its f32
  partial sums. LoRA's ``lora_a`` stays whole, its rank-r intermediate goes
  through ``copy_to_tp`` (identity forward, all-reduce backward) and
  ``lora_b`` is split on F.
* row-parallel denses (o_proj, down_proj): the weight split on its input
  features K; the input this rank's columns, the output whole. The int8
  base all-reduces each row's absmax with MAX (the scale is the whole
  row's), then its s32 accumulators with SUM, and applies the scales after
  (``ops.quant``), so its output equals one process bit for bit; a plain
  product reduces f32 partial sums (``reduce_from_tp``). LoRA's ``lora_a``
  is split on K and its rank-r partial reduced before ``lora_b`` (whole).
* attention runs ``n_heads / tp`` query and ``n_kv_heads / tp`` key / value
  heads a rank (the layer's ``cfg`` is replaced by the local one, so the
  reshapes, the KV cache and the flash kernels see local heads);
* the vocabulary: the embedding table split on its rows (a masked local
  lookup, then an all-reduce that adds one nonzero row: exact), the head
  split on its rows (``CausalLM._head`` all-gathers the logits in rank
  order, so every decode reader sees whole logits; the fused CE gathers a
  chunk's logits for its statistics and reduces its dx, ``ops.fused_ce``).
* S2S (``models.s2s.S2SModel``): the group-decode adapter's ``linear`` and
  the TTS adapter's head column-parallel on their ``code_layer x padded
  audio`` outputs, each TTS-adapter block as a decoder layer. Training
  reads no whole logits: the text CE and every codebook's CE run over a
  column window of the rank's head or adapter shard (``ops.fused_ce``), and
  the head's audio slot comes from the rank(s) holding its rows (a masked
  local product, then an exact all-reduce). ``all_gather_last`` records the
  largest tensor it forms (``LARGEST_GATHER``).
* the whisper encoder (the reference's ``heads`` / ``mlp`` axes,
  ``slam_llm_tpu/models/whisper.py``): each block's q / k / v and fc1
  column-parallel (their biases split with their rows), out_proj and fc2
  row-parallel (the bias added once, after the reduce), ``n_heads / tp``
  heads a rank; the convolutions, positions and LayerNorms whole. The MLP
  projectors (``linear``, ``cov1d-linear``): linear1 column-parallel,
  linear2 row-parallel, the conv1d whole. Their row-parallel partials are
  reduced as the LLM's plain row denses' are: each rank's product in the
  compute dtype, the partials summed in f32 and rounded once.

The split is applied to the whole model after its int8 base is derived
(``ops.quant.quantize_base_params``: the per-channel scales are the whole
tensor's): ``split_for_tp`` replaces each tensor by this rank's slice and
records the split dim in the owning module's ``tp_dims``, which the
checkpoint gathers read (``parallel.sharding.ShardLayout``). The other
encoders (WavLM, BEATs, ViT / EAT, MusicFM, Spatial-AST, AV-HuBERT, BERT)
and the Q-Former stay whole on every tp rank (replicated).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

# the decoder denses by role
COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
ROW = ("o_proj", "down_proj")

# the split dim of each tensor of a dense, by role (absent: whole on every rank)
DENSE_DIMS = {
    "column": {"weight": 0, "bias": 0, "lora_b": 0, "kernel_q": 0, "kernel_scale": 0, "kernel_qr": 1,
               "kernel_qt": 1},
    "row": {"weight": 1, "lora_a": 1, "kernel_q": 1, "kernel_qr": 0, "kernel_scale_r": 0, "kernel_qt": 0},
}


class TP(NamedTuple):
    """A rank's place on the tp axis: the group, its size and this rank's
    index in it; ``role`` of a dense (``column`` / ``row``), else None."""

    group: Any
    size: int
    rank: int
    role: Optional[str] = None


def tp_of(mesh) -> Optional[TP]:
    """The mesh's tp axis, or None where it has one rank."""
    if mesh is None or mesh["tp"].size() == 1:
        return None
    return TP(mesh["tp"].get_group(), mesh["tp"].size(), mesh["tp"].get_local_rank())


# ---- collectives ----------------------------------------------------------------


def _reduce(t: torch.Tensor, tp: TP, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` all-reduced over the tp group, as a new tensor: integers and f32
    as they are, lower-precision floats summed in f32 and rounded once."""
    if t.dtype in (torch.float32, torch.float64, torch.int32, torch.int64):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=op, group=tp.group)
        return out
    out = t.float().contiguous()
    dist.all_reduce(out, op=op, group=tp.group)
    return out.to(t.dtype)


def all_reduce_max(t: torch.Tensor, tp: TP) -> torch.Tensor:
    return _reduce(t, tp, dist.ReduceOp.MAX)


def all_reduce_sum(t: torch.Tensor, tp: TP) -> torch.Tensor:
    return _reduce(t, tp)


def _gather(t: torch.Tensor, tp: TP) -> List[torch.Tensor]:
    """The tp ranks' ``t``, in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(tp.size)]
    dist.all_gather(parts, t, group=tp.group)
    return parts


# the largest tensor ``all_gather_last`` formed since ``reset_largest_gather``:
# its element count and shape (the memory tests and chip_smoke read it)
LARGEST_GATHER: Dict[str, Any] = {"numel": 0, "shape": None}


def reset_largest_gather() -> None:
    LARGEST_GATHER.update(numel=0, shape=None)


def all_gather_last(t: torch.Tensor, tp: TP) -> torch.Tensor:
    """The tp ranks' ``t`` concatenated along the last axis, in rank order."""
    out = torch.cat(_gather(t, tp), dim=-1)
    if out.numel() > LARGEST_GATHER["numel"]:
        LARGEST_GATHER.update(numel=out.numel(), shape=tuple(out.shape))
    return out


def all_gather_stack(t: torch.Tensor, tp: TP) -> torch.Tensor:
    """The tp ranks' ``t`` stacked on a new leading axis, in rank order."""
    return torch.stack(_gather(t, tp))


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.tp), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce_sum(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.n = tp, x.shape[-1]
        return all_gather_last(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.tp.rank * ctx.n, ctx.n), None


def copy_to_tp(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """Identity forward; the gradient's partial sums all-reduced over tp."""
    return _CopyToTP.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The partial sums all-reduced over tp; the gradient passed as it is."""
    return _ReduceFromTP.apply(x, tp)


def gather_last(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The ranks' last-axis shards concatenated in rank order; the gradient
    of this rank's shard is its slice of the whole gradient. Right only
    where whatever reads the whole tensor runs the same on every tp rank."""
    return _GatherLast.apply(x, tp)


# ---- the split ----------------------------------------------------------------------


def _check_divides(what: str, n: int, size: int) -> None:
    if n % size:
        raise ValueError(f"tensor parallelism tp={size} does not divide the {what} ({n})")


def _narrow(t: torch.Tensor, dim: int, tp: TP) -> torch.Tensor:
    n = t.shape[dim] // tp.size
    return t.narrow(dim, tp.rank * n, n).contiguous()


@torch.no_grad()
def split_tensors(mod: nn.Module, dims: Dict[str, int], tp: TP) -> None:
    """Replace each of ``mod``'s own parameters / buffers named in ``dims``
    by this rank's slice along its dim, in place, and record the dims in
    ``mod.tp_dims``."""
    done = {}
    for name, dim in dims.items():
        if name in mod._parameters and mod._parameters[name] is not None:
            p = mod._parameters[name]
            p.data = _narrow(p.data, dim, tp)
        elif name in mod._buffers and mod._buffers[name] is not None:
            mod._buffers[name] = _narrow(mod._buffers[name], dim, tp)
        else:
            continue
        done[name] = dim
    mod.tp_dims = {**getattr(mod, "tp_dims", {}), **done}


def split_dense(dense: nn.Module, tp: TP, role: str) -> None:
    """A ``DenseGeneralLora`` to its ``role``'s shard; it runs with
    ``dense.tp`` from then on."""
    total = dense.features if role == "column" else dense.in_features
    split_tensors(dense, DENSE_DIMS[role], tp)
    if role == "column":
        dense.features = total // tp.size
    else:
        dense.in_features = total // tp.size
    dense.tp = tp._replace(role=role)


def check_llm_divides(cfg, size: int, owner: str = "") -> None:
    """Raise, naming the dimension (``owner`` its module, e.g. "TTS adapter's
    "), where tp does not divide a split one."""
    _check_divides(f"{owner}attention heads", cfg.n_heads, size)
    _check_divides(f"{owner}kv heads", cfg.n_kv_heads, size)
    _check_divides(f"{owner}ffn", cfg.ffn_dim, size)
    if not owner:
        _check_divides("vocabulary", cfg.vocab_size, size)
        if cfg.head_size:
            _check_divides("head vocabulary (head_size)", cfg.head_size, size)


def check_s2s_divides(model: nn.Module, size: int) -> None:
    """The S2S heads' split dimensions (``check_llm_divides`` covers the LLM)."""
    if model.group_decode_adapter is not None:
        _check_divides("group-decode adapter's audio vocabularies (code_layer x padded audio)",
                       model.group_decode_adapter.linear.features, size)
    if model.cfg.tts_adapter:
        _check_divides("TTS adapter head's audio vocabularies (code_layer x padded audio)",
                       model.tts_adapter_head.features, size)
        check_llm_divides(model.adapter_cfg, size, "TTS adapter's ")


def check_whisper_divides(cfg, size: int) -> None:
    """The whisper encoder's split dimensions: its heads and its MLP
    (``4 * d_model``)."""
    _check_divides("whisper encoder's attention heads", cfg.n_heads, size)
    _check_divides("whisper encoder's mlp (4 x d_model)", 4 * cfg.d_model, size)


def check_projector_divides(projector: nn.Module, size: int) -> None:
    """An MLP projector's hidden width (linear1's outputs)."""
    _check_divides("projector's hidden width", projector.linear1.features, size)


@torch.no_grad()
def split_whisper(encoder: nn.Module, tp: TP) -> None:
    """One ``models.whisper.WhisperEncoder`` to this rank's shard, in place:
    each block's attention runs ``n_heads / tp`` heads from then on."""
    check_whisper_divides(encoder.cfg, tp.size)
    for block in encoder.layers:
        attn = block.attn
        for name in ("q_proj", "k_proj", "v_proj"):
            split_dense(getattr(attn, name), tp, "column")
        split_dense(attn.out_proj, tp, "row")
        split_dense(block.fc1, tp, "column")
        split_dense(block.fc2, tp, "row")
        attn.n_heads //= tp.size


@torch.no_grad()
def split_projector(projector: nn.Module, tp: TP) -> None:
    """A ``ProjectorConcat`` / ``ProjectorConv1d`` to this rank's shard, in
    place: linear1 column-parallel, linear2 row-parallel."""
    check_projector_divides(projector, tp.size)
    split_dense(projector.linear1, tp, "column")
    split_dense(projector.linear2, tp, "row")


@torch.no_grad()
def split_decoder_layer(layer: nn.Module, tp: TP) -> None:
    """One ``models.llm.DecoderLayer`` to this rank's shard, in place: its
    attention runs the local heads from then on."""
    attn, mlp = layer.attn, layer.mlp
    for name in COLUMN + ROW:
        owner = attn if hasattr(attn, name) else mlp
        split_dense(getattr(owner, name), tp, "column" if name in COLUMN else "row")
    split_tensors(attn, {"prefix_k": 1, "prefix_v": 1, "adaption_gate": 0}, tp)
    c = attn.cfg
    attn.cfg = dataclasses.replace(c, n_heads=c.n_heads // tp.size, n_kv_heads=c.n_kv_heads // tp.size)


@torch.no_grad()
def split_llm(llm: nn.Module, tp: TP) -> None:
    """One ``models.llm.CausalLM`` to this rank's shard, in place."""
    check_llm_divides(llm.cfg, tp.size)
    for layer in llm.layers:
        split_decoder_layer(layer, tp)
    split_tensors(llm.embed_tokens, {"weight": 0}, tp)
    llm.embed_tokens.num_embeddings //= tp.size
    if hasattr(llm, "lm_head"):
        split_dense(llm.lm_head, tp, "column")
    split_tensors(llm, {"head_q": 0, "head_scale": 0, "head_qt": 1}, tp)
    llm.tp = tp


@torch.no_grad()
def split_s2s_heads(model: nn.Module, tp: TP) -> List[str]:
    """An S2S model's heads past the LLM to this rank's shard, in place:
    the group-decode adapter and the TTS adapter's head column-parallel,
    the TTS adapter's blocks as decoder layers. Returns the split modules."""
    split = []
    if model.group_decode_adapter is not None:
        split_dense(model.group_decode_adapter.linear, tp, "column")
        split.append("group_decode_adapter")
    for i, block in enumerate(model.tts_adapter_blocks):
        split_decoder_layer(block, tp)
        split.append(f"tts_adapter_{i}")
    if model.cfg.tts_adapter:
        split_dense(model.tts_adapter_head, tp, "column")
        split.append("tts_adapter_head")
    model.tp = tp
    return split


def split_for_tp(model: nn.Module, mesh) -> List[str]:
    """Replace the whole tensors of every decoder LLM (``CausalLM``) in
    ``model``, of an S2S model's heads, of every whisper encoder and of every
    MLP projector (``linear`` / ``cov1d-linear``) by this rank's slices,
    after ``quantize_base_params``; the rest of the model stays whole
    (replicated over tp: ``replicated_modules``). Every split dimension is
    checked before any tensor is touched. Returns the names of the split
    modules. A model with no ``CausalLM`` (VALL-E X) raises."""
    from slam_llm_tpu_torch.models.llm import CausalLM
    from slam_llm_tpu_torch.models.projector import ProjectorConcat, ProjectorConv1d
    from slam_llm_tpu_torch.models.s2s import S2SModel
    from slam_llm_tpu_torch.models.whisper import WhisperEncoder

    tp = tp_of(mesh)
    if tp is None:
        return []
    llms = [(name, m) for name, m in model.named_modules() if isinstance(m, CausalLM)]
    if not llms:
        raise NotImplementedError(
            f"tensor parallelism splits the decoder LLM (models.llm.CausalLM); {type(model).__name__} has none "
            "(ROADMAP Queue 1: the tp split of the other model families)")
    s2s = [(name, m) for name, m in model.named_modules() if isinstance(m, S2SModel)]
    encoders = [(name, m) for name, m in model.named_modules() if isinstance(m, WhisperEncoder)]
    projectors = [(name, m) for name, m in model.named_modules() if isinstance(m, (ProjectorConcat, ProjectorConv1d))]
    for _, llm in llms:
        check_llm_divides(llm.cfg, tp.size)
    for _, m in s2s:
        check_s2s_divides(m, tp.size)
    for _, enc in encoders:
        check_whisper_divides(enc.cfg, tp.size)
    for _, proj in projectors:
        check_projector_divides(proj, tp.size)
    for _, llm in llms:
        split_llm(llm, tp)
    names = [name or type(model).__name__ for name, _ in llms]
    for prefix, m in s2s:
        names += [f"{prefix}.{n}" if prefix else n for n in split_s2s_heads(m, tp)]
    for name, enc in encoders:
        split_whisper(enc, tp)
        names.append(name)
    for name, proj in projectors:
        split_projector(proj, tp)
        names.append(name)
    return names


def replicated_modules(model: nn.Module, split: List[str]) -> List[str]:
    """The top-level modules that hold tensors and stay whole over tp (the
    whole parts of a split module, whisper's convolutions and LayerNorms or
    the conv1d projector's convolution, are not listed)."""
    return [name for name, m in model.named_children()
            if name not in split and any(True for _ in m.parameters())]


def tp_dim(model: nn.Module, name: str) -> Optional[int]:
    """The tp split dim of the parameter / buffer ``name`` of ``model``, or
    None where it is whole on every tp rank."""
    owner, _, leaf = name.rpartition(".")
    mod = model.get_submodule(owner) if owner else model
    return getattr(mod, "tp_dims", {}).get(leaf)
