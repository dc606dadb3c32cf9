"""Tensor parallelism: a Megatron-style split over ``tp`` of every module the
reference annotates with ``heads`` / ``mlp`` / ``vocab``.

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
* the other families the reference annotates with ``heads`` / ``mlp`` /
  ``vocab``, in the same pattern (q / k / v and the MLP's first dense
  column-parallel, the output projection and the MLP's second row-parallel,
  ``n_heads / tp`` heads a rank): the Q-Former (both attentions; its output
  ``linear`` column-parallel and gathered before the LayerNorm, which reads
  the whole row), the WavLM layer of WavLM / HuBERT / emotion2vec, BEATs
  and AV-HuBERT (the rel-pos table and ``gru_rel_pos_const`` on their heads
  axis; the hd -> 8 gate dense whole, its gradient summed over the ranks,
  since each rank feeds it its own heads), the ViT block of EAT and
  Spatial-AST, MusicFM's Conformer (the GLU's pointwise conv split on each
  half, ``Grouped``; the depthwise conv and its BatchNorm on the rank's
  channels) and VALL-E X (the blocks; AdaLN's ``mod`` column-parallel and
  gathered before its ``chunk``; the embeddings on their rows, looked up as
  the LLM's are; both heads on the audio vocabulary, their CE
  vocab-parallel, ``ops.fused_ce.windowed_logits_ce``).

The split is applied to the whole model after its int8 base is derived
(``ops.quant.quantize_base_params``: the per-channel scales are the whole
tensor's): ``split_for_tp`` replaces each tensor by this rank's slice and
records the split dim in the owning module's ``tp_dims``, which the
checkpoint gathers read (``parallel.sharding.ShardLayout``): an int, or a
``Grouped`` dim whose halves are split each. What stays whole on every tp
rank (``replicated_modules``) carries no ``heads`` / ``mlp`` / ``vocab``
axis in the reference: conv frontends, positional convs, LayerNorms, the
stems and trunks, BERT / CLAP, the codecs and vocoders.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, NamedTuple, Optional, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
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


def vocab_parallel_lookup(ids: torch.Tensor, table: torch.Tensor, tp: TP) -> torch.Tensor:
    """Rows ``ids`` of a table split over tp on its rows (``table``: this
    rank's): a masked local lookup, the other rows' ranks adding zeros, then
    an all-reduce (exact: one nonzero row each); the gradient reaches this
    rank's rows."""
    n = table.shape[0]
    local = ids - tp.rank * n
    mine = (local >= 0) & (local < n)
    rows = F.embedding(local.clamp(0, n - 1), table)
    return reduce_from_tp(torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype)), tp)


# ---- the split ----------------------------------------------------------------------


def _check_divides(what: str, n: int, size: int) -> None:
    if n % size:
        raise ValueError(f"tensor parallelism tp={size} does not divide the {what} ({n})")


class Grouped(NamedTuple):
    """A split dim made of ``groups`` equal parts, each split over tp on its
    own (a GLU's ``[a | b]`` outputs): a rank holds its window of every part."""

    dim: int
    groups: int


Split = Union[int, Grouped]


def split_dim(spec: Split) -> int:
    return spec.dim if isinstance(spec, Grouped) else spec


def narrow_shard(t: torch.Tensor, spec: Split, tp: TP) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t`` along ``spec``."""
    dim, groups = (spec.dim, spec.groups) if isinstance(spec, Grouped) else (spec, 1)
    parts = t.unflatten(dim, (groups, t.shape[dim] // groups))
    n = parts.shape[dim + 1] // tp.size
    return parts.narrow(dim + 1, tp.rank * n, n).flatten(dim, dim + 1).contiguous()


def gather_shard(t: torch.Tensor, spec: Split, tp: TP) -> torch.Tensor:
    """The whole tensor of the tp ranks' slices ``t`` along ``spec`` (a
    collective every tp rank joins)."""
    dim, groups = (spec.dim, spec.groups) if isinstance(spec, Grouped) else (spec, 1)
    parts = [p.unflatten(dim, (groups, p.shape[dim] // groups)) for p in all_gather_stack(t, tp).unbind(0)]
    return torch.cat(parts, dim=dim + 1).flatten(dim, dim + 1)


@torch.no_grad()
def split_tensors(mod: nn.Module, dims: Dict[str, Split], tp: TP) -> None:
    """Replace each of ``mod``'s own parameters / buffers named in ``dims``
    by this rank's slice along its dim, in place, and record the dims in
    ``mod.tp_dims``."""
    done = {}
    for name, dim in dims.items():
        if name in mod._parameters and mod._parameters[name] is not None:
            p = mod._parameters[name]
            p.data = narrow_shard(p.data, dim, tp)
        elif name in mod._buffers and mod._buffers[name] is not None:
            mod._buffers[name] = narrow_shard(mod._buffers[name], dim, tp)
        else:
            continue
        done[name] = dim
    mod.tp_dims = {**getattr(mod, "tp_dims", {}), **done}


def split_dense(dense: nn.Module, tp: TP, role: str, groups: int = 1) -> None:
    """A ``DenseGeneralLora`` to its ``role``'s shard; it runs with
    ``dense.tp`` from then on. ``groups`` (column): its outputs are that
    many equal parts, each split on its own (``Grouped``)."""
    total = dense.features if role == "column" else dense.in_features
    dims = DENSE_DIMS[role]
    if groups > 1:
        dims = {name: Grouped(dim, groups) for name, dim in dims.items()}
    split_tensors(dense, dims, tp)
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


def _split_attention(owner: nn.Module, q: str, k: str, v: str, out: str, tp: TP) -> None:
    """q / k / v column-parallel, ``out`` row-parallel (the caller sets the
    rank's head count)."""
    for name in (q, k, v):
        split_dense(getattr(owner, name), tp, "column")
    split_dense(getattr(owner, out), tp, "row")


def _split_mlp(first: nn.Module, second: nn.Module, tp: TP) -> None:
    split_dense(first, tp, "column")
    split_dense(second, tp, "row")


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
        _split_attention(block.attn, "q_proj", "k_proj", "v_proj", "out_proj", tp)
        block.attn.n_heads //= tp.size
        _split_mlp(block.fc1, block.fc2, tp)


@torch.no_grad()
def split_projector(projector: nn.Module, tp: TP) -> None:
    """A ``ProjectorConcat`` / ``ProjectorConv1d`` to this rank's shard, in
    place: linear1 column-parallel, linear2 row-parallel."""
    check_projector_divides(projector, tp.size)
    _split_mlp(projector.linear1, projector.linear2, tp)


def check_qformer_divides(cfg, size: int) -> None:
    """The Q-Former's split dimensions: its heads, its MLP (4 x qformer_dim)
    and its output width (``llm_dim``)."""
    _check_divides("Q-Former's attention heads", cfg.qformer_heads, size)
    _check_divides("Q-Former's mlp (4 x qformer_dim)", 4 * cfg.qformer_dim, size)
    _check_divides("Q-Former's output width (llm_dim)", cfg.llm_dim, size)


@torch.no_grad()
def split_qformer(projector: nn.Module, tp: TP) -> None:
    """A ``ProjectorQFormer`` to this rank's shard, in place: each block's
    self and cross attention column / row-parallel at ``qformer_heads / tp``
    heads (the cross attention's k / v over the whole encoder output), fc1
    column- and fc2 row-parallel, the output ``linear`` column-parallel
    (gathered before ``norm``); ``query`` and the LayerNorms whole."""
    cfg = projector.cfg
    check_qformer_divides(cfg, tp.size)
    for i in range(cfg.qformer_layers):
        block = getattr(projector, f"block_{i}")
        for prefix in ("self", "cross"):
            _split_attention(block, f"{prefix}_q_proj", f"{prefix}_k_proj", f"{prefix}_v_proj", f"{prefix}_out_proj",
                             tp)
        block.n_heads //= tp.size  # both attentions'
        _split_mlp(block.fc1, block.fc2, tp)
    split_dense(projector.linear, tp, "column")
    projector.tp = tp


def _wavlm_parts(encoder: nn.Module):
    """(layer config, layer list, owner of ``rel_attn_embed`` or None) of a
    ``WavLMEncoder``, ``BEATsEncoder`` or ``AVHubertEncoder``."""
    from slam_llm_tpu_torch.models.beats import BEATsEncoder

    if isinstance(encoder, BEATsEncoder):
        lc = encoder.cfg.layer_cfg()
        return lc, encoder.transformer.layers, encoder.transformer if lc.rel_bias else None
    lc = encoder.cfg if hasattr(encoder.cfg, "rel_bias") else encoder.cfg.layer_cfg()
    return lc, encoder.layers, encoder if lc.rel_bias else None


def check_wavlm_divides(encoder: nn.Module, size: int) -> None:
    """A WavLM-layer encoder's split dimensions: its heads and its MLP."""
    lc, _, _ = _wavlm_parts(encoder)
    what = type(encoder).__name__
    _check_divides(f"{what}'s attention heads", lc.n_heads, size)
    _check_divides(f"{what}'s mlp (ffn_dim)", lc.ffn_dim, size)


@torch.no_grad()
def split_wavlm(encoder: nn.Module, tp: TP) -> None:
    """A ``WavLMEncoder`` (WavLM, HuBERT, emotion2vec), ``BEATsEncoder`` or
    ``AVHubertEncoder`` to this rank's shard, in place: each ``WavLMLayer``'s
    attention at ``n_heads / tp`` heads (with its ``gru_rel_pos_const``
    columns; the gate dense whole), fc1 column- and fc2 row-parallel, the
    rel-pos table on its heads axis; the conv frontend, the stems, the
    positional conv, the projections before the layers and the LayerNorms
    whole."""
    check_wavlm_divides(encoder, tp.size)
    lc, layers, table_owner = _wavlm_parts(encoder)
    for layer in layers:
        attn = layer.attention
        _split_attention(attn, "q_proj", "k_proj", "v_proj", "out_proj", tp)
        attn.n_heads //= tp.size
        if lc.rel_bias:
            split_tensors(attn, {"gru_rel_pos_const": 1}, tp)
        attn.tp = tp
        _split_mlp(layer.fc1, layer.fc2, tp)
    if table_owner is not None:
        split_tensors(table_owner, {"rel_attn_embed": 1}, tp)


def check_vit_divides(cfg, size: int) -> None:
    """A ViT stack's split dimensions (EAT, Spatial-AST): heads and MLP."""
    _check_divides("ViT's attention heads", cfg.n_heads, size)
    _check_divides("ViT's mlp (d_model x mlp_ratio)", int(cfg.d_model * cfg.mlp_ratio), size)


@torch.no_grad()
def split_vit(encoder: nn.Module, tp: TP) -> None:
    """A ``ViTEncoder`` (EAT) or ``SpatialASTEncoder`` to this rank's shard,
    in place: each ``ViTBlock`` at ``n_heads / tp`` heads, q / k / v and fc1
    column-, proj and fc2 row-parallel; the patch / conv stems, tokens,
    positions and norms whole."""
    check_vit_divides(encoder.cfg, tp.size)
    for block in encoder.blocks:
        _split_attention(block, "q_proj", "k_proj", "v_proj", "proj", tp)
        block.n_heads //= tp.size
        _split_mlp(block.fc1, block.fc2, tp)


def check_conformer_divides(cfg, size: int) -> None:
    """MusicFM's Conformer: heads (and with them the convolution module's
    ``d_model`` channels) and FFN."""
    _check_divides("MusicFM Conformer's attention heads", cfg.n_heads, size)
    _check_divides("MusicFM Conformer's ffn", cfg.ffn_dim, size)


@torch.no_grad()
def split_conformer(encoder: nn.Module, tp: TP) -> None:
    """A ``MusicFMEncoder`` to this rank's shard, in place: each
    ``ConformerLayer``'s attention at ``n_heads / tp`` heads, both FFNs
    column / row-parallel, ``pointwise_conv1`` on the rank's window of each
    GLU half (``Grouped``), the depthwise conv and ``conv_bn`` on the rank's
    ``d_model / tp`` channels, ``pointwise_conv2`` row-parallel; the conv
    frontend, ``proj`` and the LayerNorms whole."""
    check_conformer_divides(encoder.cfg, tp.size)
    for layer in encoder.layers:
        _split_attention(layer, "q_proj", "k_proj", "v_proj", "out_proj", tp)
        layer.n_heads //= tp.size
        for prefix in ("ffn1", "ffn2"):
            _split_mlp(getattr(layer, f"{prefix}_in"), getattr(layer, f"{prefix}_out"), tp)
        split_dense(layer.pointwise_conv1, tp, "column", groups=2)
        split_tensors(layer.depthwise_conv, {"weight": 0}, tp)
        split_tensors(layer.conv_bn, {"weight": 0, "bias": 0, "running_mean": 0, "running_var": 0}, tp)
        split_dense(layer.pointwise_conv2, tp, "row")


def check_vallex_divides(cfg, size: int) -> None:
    """VALL-E X's split dimensions: heads, MLP and its four vocabularies."""
    _check_divides("VALL-E X's attention heads", cfg.n_heads, size)
    _check_divides("VALL-E X's mlp (ffn_mult x d_model)", cfg.ffn_mult * cfg.d_model, size)
    _check_divides("VALL-E X's text vocabulary", cfg.text_vocab, size)
    _check_divides("VALL-E X's audio vocabulary (audio_vocab_padded)", cfg.audio_vocab_padded, size)
    _check_divides("VALL-E X's stage vocabulary (n_codebooks)", cfg.n_codebooks, size)


@torch.no_grad()
def split_vallex(model: nn.Module, tp: TP) -> None:
    """A ``VALLE`` to this rank's shard, in place: each AR / NAR block's
    attention at ``n_heads / tp`` heads, fc1 column- and fc2 row-parallel,
    AdaLN's ``mod`` column-parallel (gathered before its chunk), every
    embedding on its rows, ``ar_head`` / ``nar_head`` column-parallel over
    the audio vocabulary; positions and the final norms whole."""
    c = model.cfg
    check_vallex_divides(c, tp.size)
    for stack in (model.ar_decoder, model.nar_decoder):
        for block in stack.layers:
            _split_attention(block, "q_proj", "k_proj", "v_proj", "out_proj", tp)
            block.n_heads //= tp.size
            _split_mlp(block.fc1, block.fc2, tp)
            if block.adaptive:
                for norm in (block.norm1, block.norm2):
                    split_dense(norm.mod, tp, "column")
                    norm.tp = tp
    tables = ["text_embedding", *(f"audio_embedding_{i}" for i in range(c.n_codebooks)), "nar_stage_embedding"]
    for name in tables:
        table = getattr(model, name)
        split_tensors(table, {"weight": 0}, tp)
        table.num_embeddings //= tp.size
    for head in (model.ar_head, model.nar_head):
        split_dense(head, tp, "column")
    model.tp = tp


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


def _splits(model: nn.Module):
    """Every module of ``model`` that tp splits: (name, module, check, split)."""
    from slam_llm_tpu_torch.models.avhubert import AVHubertEncoder
    from slam_llm_tpu_torch.models.beats import BEATsEncoder
    from slam_llm_tpu_torch.models.llm import CausalLM
    from slam_llm_tpu_torch.models.musicfm import MusicFMEncoder
    from slam_llm_tpu_torch.models.projector import ProjectorConcat, ProjectorConv1d, ProjectorQFormer
    from slam_llm_tpu_torch.models.spatial_ast import SpatialASTEncoder
    from slam_llm_tpu_torch.models.vallex import VALLE
    from slam_llm_tpu_torch.models.vit import ViTEncoder
    from slam_llm_tpu_torch.models.wavlm import WavLMEncoder
    from slam_llm_tpu_torch.models.whisper import WhisperEncoder

    rules = (
        (CausalLM, lambda m, n: check_llm_divides(m.cfg, n), split_llm),
        (WhisperEncoder, lambda m, n: check_whisper_divides(m.cfg, n), split_whisper),
        ((ProjectorConcat, ProjectorConv1d), check_projector_divides, split_projector),
        (ProjectorQFormer, lambda m, n: check_qformer_divides(m.cfg, n), split_qformer),
        ((WavLMEncoder, BEATsEncoder, AVHubertEncoder), check_wavlm_divides, split_wavlm),
        ((ViTEncoder, SpatialASTEncoder), lambda m, n: check_vit_divides(m.cfg, n), split_vit),
        (MusicFMEncoder, lambda m, n: check_conformer_divides(m.cfg, n), split_conformer),
        (VALLE, lambda m, n: check_vallex_divides(m.cfg, n), split_vallex),
    )
    out = []
    for name, mod in model.named_modules():
        for cls, check, split in rules:
            if isinstance(mod, cls):
                out.append((name, mod, check, split))
    return out


def split_for_tp(model: nn.Module, mesh) -> List[str]:
    """Replace the whole tensors of every module of ``model`` that the
    reference annotates with ``heads`` / ``mlp`` / ``vocab`` by this rank's
    slices, after ``quantize_base_params``: every decoder LLM
    (``CausalLM``), an S2S model's heads, the whisper, WavLM-layer (WavLM,
    HuBERT, emotion2vec, BEATs, AV-HuBERT), ViT (EAT, Spatial-AST) and
    MusicFM encoders, every projector (``linear``, ``cov1d-linear``,
    ``q-former``) and VALL-E X. The rest stays whole (replicated over tp:
    ``replicated_modules``). Every split dimension is checked before any
    tensor is touched. Returns the names of the split modules."""
    from slam_llm_tpu_torch.models.s2s import S2SModel

    tp = tp_of(mesh)
    if tp is None:
        return []
    splits = _splits(model)
    s2s = [(name, m) for name, m in model.named_modules() if isinstance(m, S2SModel)]
    for _, mod, check, _ in splits:
        check(mod, tp.size)
    for _, m in s2s:
        check_s2s_divides(m, tp.size)
    names = []
    for name, mod, _, split in splits:
        split(mod, tp)
        names.append(name or type(model).__name__)
    for prefix, m in s2s:
        names += [f"{prefix}.{n}" if prefix else n for n in split_s2s_heads(m, tp)]
    return names


def _is_split(mod: nn.Module) -> bool:
    return bool(getattr(mod, "tp_dims", None))


def replicated_modules(model: nn.Module) -> List[str]:
    """What stays whole over tp: the largest modules (and the own tensors
    of split ones, such as a row-parallel dense's bias) none of whose
    tensors is split, as patterns with each layer index (``layers.3``,
    ``block_3``) replaced by ``*`` (one entry for all layers)."""
    whole = {}

    def visit(prefix: str, mod: nn.Module) -> bool:
        """Whether nothing under ``mod`` is split; lists the largest whole parts."""
        kids = {name: visit(f"{prefix}{name}.", child) for name, child in mod.named_children()}
        if not _is_split(mod) and all(kids.values()):
            return True
        for name, ok in kids.items():
            child = getattr(mod, name)
            if ok and any(True for _ in child.parameters()):
                whole[f"{prefix}{name}"] = None
        own = [n for n, _ in [*mod.named_parameters(recurse=False), *mod.named_buffers(recurse=False)]
               if n not in getattr(mod, "tp_dims", {})]
        for n in own:
            whole[f"{prefix}{n}"] = None
        return False

    if visit("", model):
        return [type(model).__name__]
    return list(dict.fromkeys(re.sub(r"(^|\.|_)\d+(?=\.|$)", r"\1*", name) for name in whole))


def tp_dim(model: nn.Module, name: str) -> Optional[Split]:
    """The tp split dim of the parameter / buffer ``name`` of ``model``, or
    None where it is whole on every tp rank."""
    owner, _, leaf = name.rpartition(".")
    mod = model.get_submodule(owner) if owner else model
    return getattr(mod, "tp_dims", {}).get(leaf)
