"""Shared building blocks: dense + LoRA, norms, RoPE, attention.

Counterpart of ``slam_llm_tpu/models/layers.py``. Numerics follow the
reference: dense products run in the compute ``dtype``; norms reduce in f32;
attention scores and softmax are f32 over compute-dtype operands.

Parameter storage: trainable tensors (LoRA factors, the projector's kernels
and biases, and whatever else ``train.optimizer.param_label`` marks
``train``) are f32 masters (``param_dtype``), cast to the compute dtype at
use, as in the reference. Frozen dense and conv kernels, biases and
embeddings are stored in the compute dtype, the dtype the reference's
trainer casts the frozen subtree to and every use casts to; norm scales and
biases are stored in f32 and read in f32. Every use casts a weight to the
compute dtype, so a tensor the trainer re-stores (f32 masters, bf16 frozen
copies) needs no other change.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from slam_llm_tpu_torch.models.remat import DEAD_SITES, SumOf, Tape, placeholder
from slam_llm_tpu_torch.ops.kernels.flash_attention import Rope, apply_rope_tables, flash_attention
from slam_llm_tpu_torch.ops.quant import SharedActQuant, int8_dot, int8_of
from slam_llm_tpu_torch.parallel.tensor_parallel import copy_to_tp, reduce_from_tp

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


class _Linear(torch.autograd.Function):
    """``x @ w^T`` whose backward reads only its inputs (dx = dy w, and
    dw = dy^T x when w trains). With ``out`` the forward returns ``out``
    instead of computing the product: a checkpointed layer's replay that
    already holds the value, or whose value nothing reads."""

    @staticmethod
    def forward(ctx, x, w, out):
        ctx.save_for_backward(x if w.requires_grad else None, w)
        return F.linear(x, w) if out is None else out

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy2 = dy.reshape(-1, dy.shape[-1])
        dx = dy2.mm(w).reshape(*dy.shape[:-1], w.shape[1]) if ctx.needs_input_grad[0] else None
        dw = dy2.t().mm(x.reshape(-1, x.shape[-1])) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def linear(x: torch.Tensor, w: torch.Tensor, out: Optional[torch.Tensor] = None,
           w_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w^T``; with ``w_t`` (== ``w.T``, stored) its backward contracts
    the stored transpose (``_PretransposedLinear``)."""
    if not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)):
        return F.linear(x, w) if out is None else out
    if w_t is not None:
        return _PretransposedLinear.apply(x, w, w_t, out)
    return _Linear.apply(x, w, out)


class _PretransposedLinear(torch.autograd.Function):
    """``x @ w^T`` whose backward contracts a stored transpose ``w_t == w.T``
    (K, F): dx = dy w_t^T reads ``w_t`` row-major, as the forward reads
    ``w``. The reference's ``_pretransposed_dot``: the weight gradient is
    exact (dw = dy^T x, when w trains) and ``w_t`` gets none, which is why
    the trainer refuses it for a base that trains. ``out`` as in ``_Linear``."""

    @staticmethod
    def forward(ctx, x, w, w_t, out):
        ctx.save_for_backward(x if w.requires_grad else None, w_t)
        return F.linear(x, w) if out is None else out

    @staticmethod
    def backward(ctx, dy):
        x, w_t = ctx.saved_tensors
        dy2 = dy.reshape(-1, dy.shape[-1])
        dx = F.linear(dy, w_t) if ctx.needs_input_grad[0] else None
        dw = dy2.t().mm(x.reshape(-1, x.shape[-1])) if ctx.needs_input_grad[1] else None
        return dx, dw, None, None


class DenseGeneralLora(nn.Module):
    """``y = x W^T (+ b) + (dropout(x) A^T * alpha/r) B^T``.

    ``quant="int8"`` stores the frozen base as ``kernel_q`` (F, K) int8 and
    ``kernel_scale`` (F,) f32 and runs it through ``int8_dot`` (K2 + K3 on
    CUDA), whose backward is ``quant_bwd``; ``"int8_rot"`` adds the rotated
    backward pair ``kernel_qr`` (K, F) int8 and ``kernel_scale_r`` (K,) f32,
    ``"int8_sr"`` and ``"int8"`` the transpose ``kernel_qt`` (K, F) int8, all
    derived by ``ops.quant.quantize_base_params`` and never loaded (they are
    not in the state dict). ``quant_seed`` is the uint32 seed of the
    stochastic dy quantization (int8_rot, int8_rot_otf, int8_sr), set fresh
    per step by the trainer. Otherwise ``weight`` (F, K) is a plain product.
    ``frozen_base`` stores the kernel and bias in the compute dtype; a
    trainable base keeps them in ``param_dtype``. LoRA ``lora_a`` (r, K) and
    ``lora_b`` (F, r) are ``param_dtype`` masters; the LoRA scale multiplies
    the rank-r intermediate, and LoRA dropout (training mode only) applies
    to the LoRA input, drawn from ``generator``.

    Under activation checkpointing (``tape``, ``models.remat``) the dense is
    the checkpoint site ``site`` (``attn_q`` ...), and each of its matrix
    products a ``dot`` site. ``pre_quant`` (an int8 base only): the
    ``ops.quant.SharedActQuant`` of this input, which the denses over one
    input share, asked only if the base product is computed.

    ``pretranspose_bwd`` (a plain base only, the reference's
    ``shard.bwd_pretranspose``): the frozen base keeps ``kernel_t`` (K, F), a
    stored ``weight.T``, whose backward dx product contracts it
    (``_PretransposedLinear``). It is derived, never loaded (not in the
    state dict): ``refresh_pretransposed`` writes it, after the base is
    loaded and split.

    Tensor parallelism (``tp``, set by ``parallel.tensor_parallel.split_dense``):
    a ``column`` shard holds F / tp output features (``lora_b`` split, ``lora_a``
    whole, its rank-r intermediate through ``copy_to_tp``) and takes x whole;
    a ``row`` shard holds K / tp input features (``lora_a`` split, its rank-r
    partial reduced before the whole ``lora_b``; the bias added once, after
    the reduction) and returns the whole output. Either returns x's whole
    gradient. ``features`` / ``in_features`` are the local widths; a row
    shard's LoRA dropout draws the whole row's mask and keeps its columns.
    """

    def __init__(
        self, in_features: int, features: int, *, use_bias: bool = False,
        dtype: torch.dtype = torch.bfloat16, param_dtype: torch.dtype = torch.float32,
        frozen_base: bool = True, lora_rank: int = 0, lora_alpha: float = 32.0,
        lora_dropout: float = 0.0, quant: str = "none", quant_bwd: str = "bf16", pretranspose_bwd: bool = False,
        device=None,
    ):
        super().__init__()
        if quant not in ("none", "int8"):
            raise ValueError(f"unknown quant {quant!r}")
        if quant == "int8" and pretranspose_bwd:
            raise ValueError("quant='int8' and pretranspose_bwd are exclusive")
        self.in_features, self.features = in_features, features
        self.dtype, self.quant, self.quant_bwd = dtype, quant, quant_bwd
        self.lora_rank, self.lora_alpha, self.lora_dropout = lora_rank, lora_alpha, lora_dropout
        # the reference multiplies by the scale rounded to the compute dtype
        self.lora_scale = float(torch.tensor(lora_alpha / max(lora_rank, 1), dtype=dtype))
        self.quant_seed = 0
        self.generator: Optional[torch.Generator] = None
        self.tp = None  # parallel.tensor_parallel.TP with its role, under tensor parallelism
        base_dtype = dtype if frozen_base else param_dtype
        if quant == "int8":
            self.register_buffer(
                "kernel_q", torch.zeros(features, in_features, dtype=torch.int8, device=device)
            )
            self.register_buffer(
                "kernel_scale", torch.ones(features, dtype=torch.float32, device=device)
            )
            if quant_bwd == "int8_rot":
                self.register_buffer("kernel_qr", torch.zeros(
                    in_features, features, dtype=torch.int8, device=device), persistent=False)
                self.register_buffer("kernel_scale_r", torch.ones(
                    in_features, dtype=torch.float32, device=device), persistent=False)
            elif quant_bwd in ("int8_sr", "int8"):
                self.register_buffer("kernel_qt", torch.zeros(
                    in_features, features, dtype=torch.int8, device=device), persistent=False)
        else:
            self.weight = nn.Parameter(
                torch.zeros(features, in_features, dtype=base_dtype, device=device), requires_grad=False
            )
            if pretranspose_bwd:
                self.register_buffer("kernel_t", torch.zeros(in_features, features, dtype=base_dtype, device=device),
                                     persistent=False)
        self.bias = (
            nn.Parameter(torch.zeros(features, dtype=base_dtype, device=device), requires_grad=False)
            if use_bias else None
        )
        if lora_rank > 0:
            self.lora_a = nn.Parameter(
                torch.zeros(lora_rank, in_features, dtype=param_dtype, device=device), requires_grad=False
            )
            self.lora_b = nn.Parameter(
                torch.zeros(features, lora_rank, dtype=param_dtype, device=device), requires_grad=False
            )

    def _base(self, h: torch.Tensor, out: Optional[torch.Tensor], pre_quant: Optional[SharedActQuant]) -> torch.Tensor:
        tp = self.tp
        if self.quant == "int8":
            return int8_dot(h, int8_of(self.kernel_q), self.kernel_scale, bwd=self.quant_bwd, seed=self.quant_seed,
                            w_rot=(int8_of(self.kernel_qr), self.kernel_scale_r) if self.quant_bwd == "int8_rot" else None,
                            w_t=int8_of(getattr(self, "kernel_qt", None)), out=out, pre_quant=pre_quant, tp=tp)
        w = self.weight.to(self.dtype)
        w_t = getattr(self, "kernel_t", None)
        w_t = None if w_t is None else w_t.to(self.dtype)
        if tp is None:
            return linear(h, w, out, w_t)
        if tp.role == "column":
            return linear(copy_to_tp(h, tp), w, out, w_t)
        # row: the partial sums reduced; a replay that holds the value skips
        # the reduction, whose backward is the identity
        return linear(h, w, out, w_t) if out is not None else reduce_from_tp(linear(h, w, None, w_t), tp)

    def forward(self, x: torch.Tensor, tape: Optional[Tape] = None, site: Optional[str] = None,
                pre_quant: Optional[SharedActQuant] = None) -> torch.Tensor:
        h = x.to(self.dtype)
        # a dense whose output is saved (or read by no backward) replays
        # lazily: no product its own backward does not read is formed again
        lazy = tape is not None and site is not None and (site in DEAD_SITES or tape.saves(site))
        value = None
        if lazy and tape.replaying:
            value = (placeholder(h.shape[:-1] + (self.features,), self.dtype, h.device) if site in DEAD_SITES
                     else tape.get(self, site))

        def dot(part, compute, fn, skip):
            """One matrix product as a checkpoint site."""
            if tape is None:
                return compute()
            if tape.replaying:
                if skip:
                    return fn(placeholder(h.shape[:-1] + (self.features,), self.dtype, h.device))
                return fn(tape.get(self, part)) if tape.saves("dot") else compute()
            y = compute()
            if not skip and tape.saves("dot"):
                tape.put(self, part, y)
            return y

        y = dot("base", lambda: self._base(h, None, pre_quant), lambda out: self._base(h, out, pre_quant), lazy)
        parts = [y]
        if self.bias is not None:
            parts.append(self.bias.to(self.dtype))
        if self.lora_rank > 0:
            row = self.tp is not None and self.tp.role == "row"
            if self.lora_dropout > 0.0 and self.training:
                h = _dropout(h, self.lora_dropout, self.generator, self.tp if row else None)
            a, b = self.lora_a.to(self.dtype), self.lora_b.to(self.dtype)
            if row:  # the rank-r partial sums reduced (a saved value is the reduced one)
                inner = dot("lora_a", lambda: reduce_from_tp(linear(h, a), self.tp), lambda out: linear(h, a, out),
                            False) * self.lora_scale
            else:
                inner = dot("lora_a", lambda: linear(h, a), lambda out: linear(h, a, out), False) * self.lora_scale
                if self.tp is not None:
                    inner = copy_to_tp(inner, self.tp)
            parts.append(dot("lora_b", lambda: linear(inner, b), lambda out: linear(inner, b, out), lazy))
        if value is not None:
            return SumOf.apply(value, *parts)
        for part in parts[1:]:
            y = y + part
        if lazy and site not in DEAD_SITES:
            tape.put(self, site, y)
        return y


@torch.no_grad()
def refresh_pretransposed(model: nn.Module) -> nn.Module:
    """Rewrite every dense's ``kernel_t`` as the transpose of its own
    ``weight`` (a tp rank's: the transpose of its shard), in the weight's
    dtype and device. It runs whenever the weights may have changed (init,
    loaders, the tp split): a stale copy would make the backward silently
    wrong (the reference's ``refresh_pretransposed``)."""
    for mod in model.modules():
        if isinstance(mod, DenseGeneralLora) and getattr(mod, "kernel_t", None) is not None:
            mod.kernel_t = mod.weight.detach().t().contiguous()
    return model


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator], tp=None) -> torch.Tensor:
    """Inverted dropout with an explicit generator: keep with probability
    1 - rate and scale the kept entries by 1 / (1 - rate), as flax does.
    ``tp``: x is this rank's columns of a row-parallel input, whose mask is
    the whole row's mask's columns (drawn whole, as one process draws it)."""
    if tp is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    else:
        k = x.shape[-1]
        whole = torch.rand(x.shape[:-1] + (k * tp.size,), generator=generator, device=x.device)
        keep = whole.narrow(-1, tp.rank * k, k) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        norm = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(self.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(dim, device=device), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = (x32 - mean).square().mean(-1, keepdim=True)
        norm = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (norm * self.scale + self.bias).to(self.dtype)


def dense_f32(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``lin`` applied in f32, whatever dtype its weight is stored in (the
    CLAP family computes in f32; the trainer may store a frozen copy in
    bf16)."""
    return F.linear(x, lin.weight.float(), None if lin.bias is None else lin.bias.float())


def layer_norm_f32(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * scale + bias over the last axis, in f32."""
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + ln.eps) * ln.weight.float() + ln.bias.float()


def pick_state(sd, module: nn.Module):
    """The tensors of ``sd`` under ``module``'s ``state_dict`` names (build
    it on the meta device), as f32 CPU tensors; a missing name raises
    ``KeyError``. A converter whose module keeps the reference's names."""
    names = list(module.state_dict().keys())
    missing = [n for n in names if n not in sd]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} tensors, e.g. {missing[:3]}")
    return {n: torch.as_tensor(sd[n]).float() for n in names}


class FrozenBatchNorm(nn.Module):
    """Eval-mode BatchNorm in f32 over axis ``axis``: (x - running_mean) *
    rsqrt(running_var + eps) * weight + bias, with torch's BatchNorm names
    (the CLAP towers load it pretrained and frozen). The statistics are
    parameters, as the JAX modules' ``mean`` / ``var`` leaves are: a
    trainer trains them with the encoder and stores them in
    ``frozen_dtype`` when it is frozen."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(dim, device=device), requires_grad=False)
        self.running_mean = nn.Parameter(torch.zeros(dim, device=device), requires_grad=False)
        self.running_var = nn.Parameter(torch.ones(dim, device=device), requires_grad=False)

    def forward(self, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
        shape = [1] * x.ndim
        shape[axis] = -1
        inv = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        return (x - self.running_mean.float().reshape(shape)) * inv.reshape(shape) + self.bias.float().reshape(shape)


# ---------------------------------------------------------------------------
# Rotary position embeddings (HF-llama rotate-half layout)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """(cos, sin), each (B, T, D/2) f32."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions.float()[..., None] * freqs[None, None, :]
    return torch.cos(angles), torch.sin(angles)


# ---------------------------------------------------------------------------
# Attention core
# ---------------------------------------------------------------------------


def mha_attention(
    q: torch.Tensor,  # (B, Tq, H, D)
    k: torch.Tensor,  # (B, Tk, Hkv, D)
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,  # (B, 1|H, Tq, Tk) additive f32
    kv_mask: Optional[torch.Tensor] = None,  # (B, Tk) structured key validity
    causal: bool = False,
    rope: Rope = None,  # (cos, sin) (B, T, D/2): q/k come PRE-rotation
    tape: Optional[Tape] = None,  # activation checkpointing (models.remat)
    owner: Optional[nn.Module] = None,  # the tape's key for this call
) -> torch.Tensor:
    """Multi-head attention with GQA. A structured mask (no ``bias``) on a
    CUDA tensor runs the flash kernels (K1 forward, K4 backward), with the
    RoPE rotation fused into them when ``rope`` is given, as the checkpoint
    site ``flash`` of ``owner`` under a ``tape``; a dense bias, a CPU
    tensor, causal with Tq != Tk (end-aligned, which only the plain path
    defines), rope with Tq != Tk or a head_dim the kernels do not take
    (``flash_head_dim``) rotates first and runs the plain path."""
    use_kernel = bias is None and q.is_cuda and not (
        (causal or rope is not None) and q.shape[1] != k.shape[1]
    ) and flash_head_dim(q.shape[-1])
    if use_kernel:
        mask = (
            kv_mask.to(torch.int32)
            if kv_mask is not None
            else torch.ones(k.shape[:2], dtype=torch.int32, device=k.device)
        )
        return flash_attention(q, k, v, mask, causal, rope, tape=tape, owner=owner)
    if rope is not None:
        q = apply_rope_tables(q, *rope)
        k = apply_rope_tables(k, *rope)
    return _xla_attention(q, k, v, bias, kv_mask, causal)


def flash_head_dim(d: int) -> bool:
    """Whether a structured call at head_dim ``d`` runs the flash kernels
    (every D % 64 == 0, where the JAX package runs its Pallas kernels: D
    64 to 256 on the TMA / wgmma kernels, wider on the panel route) or the
    plain path (D % 64 != 0, where the JAX package runs XLA too)."""
    return d % 64 == 0


def _xla_attention(q, k, v, bias, kv_mask=None, causal=False):
    """Plain attention: f32 scores over compute-dtype operands, f32 softmax,
    probabilities cast to v's dtype for the value product. Query rows whose
    every key is masked output 0 (the flash kernel's convention)."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, tq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * (1.0 / math.sqrt(d))
    row_live = None
    if bias is None and (kv_mask is not None or causal):
        mask = (
            kv_mask.bool()[:, None, None, :]
            if kv_mask is not None
            else torch.ones(b, 1, 1, tk, dtype=torch.bool, device=q.device)
        )
        if causal:
            mask = mask & torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril(tk - tq)
        bias = torch.where(mask, 0.0, NEG_INF).float()
    if bias is not None:
        row_live = (bias > NEG_INF * 0.5).any(-1)  # (B, 1|H, Tq)
        bh = bias.shape[1]
        # a per-head bias (B, H, Tq | 1, Tk) splits its heads into groups; a
        # shared one (B, 1, ...) broadcasts (both at one head, a tp rank's)
        bias5 = bias.reshape(b, hkv, g, *bias.shape[2:]) if bh == h else bias[:, :, None]
        logits = logits + bias5
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(), v.float()).reshape(b, tq, h, d)
    if row_live is not None:
        out = out * row_live.transpose(1, 2)[..., None].float()
    return out.to(v.dtype)


def make_padding_bias(attention_mask: torch.Tensor, q_len: int) -> torch.Tensor:
    """(B, Tk) key padding mask -> (B, 1, q_len, Tk) additive f32 bias."""
    mask = attention_mask.bool()[:, None, None, :].expand(-1, 1, q_len, -1)
    return torch.where(mask, 0.0, NEG_INF).float()


def sinusoidal_positions(length: int, channels: int, max_timescale: float = 10000.0, device=None):
    """Whisper-style fixed sinusoid table: (length, channels) f32."""
    log_inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = torch.exp(-log_inc * torch.arange(channels // 2, dtype=torch.float32, device=device))
    scaled = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)

