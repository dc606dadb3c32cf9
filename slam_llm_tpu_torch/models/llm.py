"""Decoder-only causal LLM (llama / tinyllama / qwen2 families) with LoRA.

Counterpart of ``slam_llm_tpu/models/llm.py``. The same module runs prefill
over spliced ``inputs_embeds`` and single-token decode steps against an
explicit KV cache (a dict of tensors, not module state). Layers are a
``ModuleList`` walked in a loop. Decoder dense layers run the int8 path
(K2 + K3 on CUDA) when ``base_quant == "int8"``, with the backward
``base_quant_bwd`` picks per module (``ops.quant.resolve_bwd``). The
training path (no cache) runs the flash kernels with RoPE fused (K1 forward,
K4 backward); prefill rotates first (the cache stores rotated keys) and runs
K1; decode attention is plain PyTorch. ``loss_and_accuracy`` fuses the head
into a chunked cross-entropy (``ops.fused_ce``), with an int8 head under
``ce_quant``.

With ``remat`` the training path (autograd on, no cache) checkpoints each
decoder layer with ``remat_policy`` (``models.remat``); inference never does.

Unlike the reference, whose arrays are immutable, the port writes the KV
cache in place: prefill fills the prompt prefix, and each decode step writes
its token's k/v into the generated tail after the layer has attended.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from slam_llm_tpu_torch.models.layers import (
    NEG_INF,
    DenseGeneralLora,
    RMSNorm,
    apply_rope_tables,
    make_padding_bias,
    mha_attention,
    rope_tables,
)
from slam_llm_tpu_torch.models.remat import DENSE_SITES, Tape, checkpoint_layer, policy_names
from slam_llm_tpu_torch.ops.quant import SharedActQuant, resolve_bwd


@dataclass(frozen=True)
class LLMConfig:
    vocab_size: int = 32000
    d_model: int = 2048
    n_layers: int = 22
    n_heads: int = 32
    n_kv_heads: int = 4
    head_dim: int = 64
    ffn_dim: int = 5632
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    qkv_bias: bool = False  # qwen2 uses bias on q/k/v
    tied_embeddings: bool = False
    head_size: Optional[int] = None  # lm_head width when it differs from vocab_size
    dtype: torch.dtype = torch.bfloat16
    peft_method: str = "lora"  # lora | none (prefix / adaption_prompt: not ported yet)
    lora_rank: int = 0
    lora_alpha: float = 32.0
    lora_dropout: float = 0.0
    lora_targets: Tuple[str, ...] = ("q_proj", "v_proj")
    base_quant: str = "none"  # none | int8
    # dx mode of the int8 denses: bf16 | int8_rot | int8_rot_otf | int8_sr | int8 | <mode>_mlp (ops/quant.py)
    base_quant_bwd: str = "bf16"
    ce_quant: str = "none"  # none | int8 | int8_sr: the int8 head of the fused CE (frozen head)
    remat: bool = True  # checkpoint each decoder layer on the training path
    remat_policy: str = "dots_flash_saveable"  # models.remat.POLICIES
    ce_chunk: int = 64  # fused-CE time chunk

    @staticmethod
    def tinyllama_1_1b() -> "LLMConfig":
        return LLMConfig()

    @staticmethod
    def vicuna_7b() -> "LLMConfig":
        return LLMConfig(
            vocab_size=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=32,
            head_dim=128, ffn_dim=11008, rms_eps=1e-5,
        )

    @staticmethod
    def qwen2_7b() -> "LLMConfig":
        return LLMConfig(
            vocab_size=152064, d_model=3584, n_layers=28, n_heads=28, n_kv_heads=4,
            head_dim=128, ffn_dim=18944, rope_theta=1000000.0, rms_eps=1e-6, qkv_bias=True,
        )

    @staticmethod
    def tiny_test(vocab_size: int = 256) -> "LLMConfig":
        return LLMConfig(
            vocab_size=vocab_size, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=16, ffn_dim=128,
        )


# Cache for one layer stack, in the reference's split layout: the prompt
# prefix "k"/"v" (L, B, gen_start, n_kv, head_dim), written once by prefill
# and shared by all beams of a row, apart from the generated tail
# "k_gen"/"v_gen" (L, B', max_len - gen_start, n_kv, head_dim), the only
# buffers decode writes and beam search reorders: absolute slot
# s >= gen_start lives at k_gen[:, :, s - gen_start].
KVCache = Dict[str, torch.Tensor]


def init_kv_cache(
    cfg: LLMConfig, batch: int, max_len: int, gen_start: int, dtype=None, device=None
) -> KVCache:
    if not 0 < gen_start < max_len:
        raise ValueError(f"gen_start={gen_start} must be in (0, {max_len})")
    dtype = dtype or cfg.dtype

    def _buf(n):
        return torch.zeros(
            (cfg.n_layers, batch, n, cfg.n_kv_heads, cfg.head_dim), dtype=dtype, device=device
        )

    return {"k": _buf(gen_start), "v": _buf(gen_start),
            "k_gen": _buf(max_len - gen_start), "v_gen": _buf(max_len - gen_start)}


def reorder_cache(cache: KVCache, beam_indices: torch.Tensor) -> KVCache:
    """Gather the generated tail's rows (beam reorder). The prompt prefix is
    the same for every beam of a row and stays."""
    return {
        key: val if key in ("k", "v") else val.index_select(1, beam_indices)
        for key, val in cache.items()
    }


def _shared_prefix_decode_attention(
    q: torch.Tensor,        # (B*K, 1, H, D) rotated queries
    prefix_k: torch.Tensor,  # (B, t, Hkv, D) beam-invariant prompt cache
    prefix_v: torch.Tensor,
    gen_k: torch.Tensor,    # (B*K, max_new, Hkv, D) per-beam generated tail
    gen_v: torch.Tensor,
    new_k: torch.Tensor,    # (B*K, 1, Hkv, D) this step's k/v
    new_v: torch.Tensor,
    bias: torch.Tensor,     # (B*K, 1, 1, t + max_new + 1) additive f32
) -> torch.Tensor:
    """Beam-decode attention with the prompt prefix kept at B rows: the K
    beams of a row fold into the prefix product's query dims, so the prefix
    is read once per row. One softmax runs over [prefix | gen | new] in the
    slot order of the concatenated path; all-masked rows output 0."""
    bk, tq, h, d = q.shape
    bsz, t_prefix, hkv = prefix_k.shape[0], prefix_k.shape[1], prefix_k.shape[2]
    kbeams = bk // bsz
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    dt = q.dtype

    qg = q.reshape(bsz, kbeams, hkv, g, d).float()
    lp = torch.einsum("bKhgd,bthd->bhgKt", qg, prefix_k.to(dt).float()) * scale
    lp = lp.permute(0, 3, 1, 2, 4).reshape(bk, hkv, g, 1, t_prefix)
    k_tail = torch.cat([gen_k, new_k], dim=1).to(dt)
    v_tail = torch.cat([gen_v, new_v], dim=1).to(dt)
    qt = q.reshape(bk, tq, hkv, g, d).float()
    lt = torch.einsum("bqhgd,bkhd->bhgqk", qt, k_tail.float()) * scale

    logits = torch.cat([lp, lt], dim=-1)  # (B*K, Hkv, G, 1, L+1)
    row_live = (bias > NEG_INF * 0.5).any(-1)  # (B*K, 1, 1)
    probs = torch.softmax(logits + bias[:, :, None], dim=-1)
    pp = probs[..., :t_prefix].to(dt).float().reshape(bsz, kbeams, hkv, g, t_prefix)
    pt = probs[..., t_prefix:].to(dt).float()
    out_p = torch.einsum("bKhgt,bthd->bKhgd", pp, prefix_v.to(dt).float()).reshape(bk, tq, h, d)
    out_t = torch.einsum("bhgqk,bkhd->bqhgd", pt, v_tail.float()).reshape(bk, tq, h, d)
    out = (out_p + out_t) * row_live.transpose(1, 2)[..., None].float()
    return out.to(dt)


def _dense(c: LLMConfig, name: str, fin: int, fout: int, use_bias: bool, device) -> DenseGeneralLora:
    return DenseGeneralLora(
        fin, fout, use_bias=use_bias, dtype=c.dtype,
        lora_rank=c.lora_rank if name in c.lora_targets else 0, lora_alpha=c.lora_alpha,
        lora_dropout=c.lora_dropout, quant=c.base_quant, quant_bwd=resolve_bwd(c.base_quant_bwd, name),
        device=device,
    )


def _shared_quant(c: LLMConfig, x: torch.Tensor) -> Optional[SharedActQuant]:
    """The int8 form of a dense input that several int8 denses read, formed
    lazily by the first one that computes its product."""
    return SharedActQuant(x.to(c.dtype)) if c.base_quant == "int8" else None


class Attention(nn.Module):
    def __init__(self, cfg: LLMConfig, device=None):
        super().__init__()
        self.cfg = c = cfg
        for name, fin, fout in (
            ("q_proj", c.d_model, c.n_heads * c.head_dim),
            ("k_proj", c.d_model, c.n_kv_heads * c.head_dim),
            ("v_proj", c.d_model, c.n_kv_heads * c.head_dim),
            ("o_proj", c.n_heads * c.head_dim, c.d_model),
        ):
            setattr(self, name, _dense(c, name, fin, fout, c.qkv_bias and name != "o_proj", device))

    def forward(
        self,
        x: torch.Tensor,  # (B, T, D)
        positions: torch.Tensor,  # (B, T)
        *,
        kv_mask: Optional[torch.Tensor] = None,  # (B, T) prefill / training mask
        bias: Optional[torch.Tensor] = None,  # (B, 1, 1, max_len) decode mask
        cache_k: Optional[torch.Tensor] = None,  # (B | B/K, prefix, Hkv, D) this layer's prefix
        cache_v: Optional[torch.Tensor] = None,
        gen_k: Optional[torch.Tensor] = None,  # (B, max_new, Hkv, D) this layer's tail (decode)
        gen_v: Optional[torch.Tensor] = None,
        cache_index: Optional[int] = None,
        tape: Optional[Tape] = None,  # training path under activation checkpointing
    ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
        """Returns ``(out, new_kv)``. Without a cache (training) RoPE is
        fused into the flash kernels; prefill (``bias`` None) writes the
        prompt's rotated k/v into ``cache_k[:, :T]`` in place; a decode step
        (``bias`` given, T == 1) only reads the cache and returns the token's
        k/v for the caller to write at ``cache_index``."""
        c = self.cfg
        b, t, _ = x.shape
        xq = _shared_quant(c, x)  # one K2 for the three projections
        q = self.q_proj(x, tape, DENSE_SITES["q_proj"], xq).reshape(b, t, c.n_heads, c.head_dim)
        k = self.k_proj(x, tape, DENSE_SITES["k_proj"], xq).reshape(b, t, c.n_kv_heads, c.head_dim)
        v = self.v_proj(x, tape, DENSE_SITES["v_proj"], xq).reshape(b, t, c.n_kv_heads, c.head_dim)
        cos, sin = rope_tables(positions, c.head_dim, c.rope_theta)
        if cache_k is None:
            # training path: the flash kernels rotate q/k as they load them
            out = mha_attention(q, k, v, kv_mask=kv_mask, causal=True, rope=(cos, sin), tape=tape, owner=self)
            return self.o_proj(out.reshape(b, t, c.n_heads * c.head_dim), tape, DENSE_SITES["o_proj"]), None
        # rotate before attention: the cache stores rotated keys
        q = apply_rope_tables(q, cos, sin)
        k = apply_rope_tables(k, cos, sin)

        new_kv = None
        if bias is not None:
            if t != 1:
                raise ValueError("a decode step takes one token per row")
            # the caller marks slot cache_index valid (this token lands
            # there): mask the stale slot and append the live token instead
            new_kv = (k.to(cache_k.dtype), v.to(cache_v.dtype))
            cols = torch.arange(cache_k.shape[1] + gen_k.shape[1], device=x.device)
            bias = torch.where(cols == cache_index, NEG_INF, bias)
            bias = F.pad(bias, (0, 1))
            if cache_k.shape[0] != b:
                # beam decode: the prefix stays at B rows, queries run at B*K
                out = _shared_prefix_decode_attention(
                    q, cache_k, cache_v, gen_k, gen_v, new_kv[0], new_kv[1], bias
                )
            else:
                kk = torch.cat([cache_k, gen_k, new_kv[0]], dim=1).to(q.dtype)
                vv = torch.cat([cache_v, gen_v, new_kv[1]], dim=1).to(q.dtype)
                out = mha_attention(q, kk, vv, bias=bias)
        else:
            # prefill: the fresh k/v ARE the cache prefix [0, t); attending
            # them directly keeps Tq == Tk, so the causal mask stays
            # structured and runs the flash kernel
            cache_k[:, :t] = k.to(cache_k.dtype)
            cache_v[:, :t] = v.to(cache_v.dtype)
            out = mha_attention(q, k, v, kv_mask=kv_mask, causal=True)
        out = self.o_proj(out.reshape(b, t, c.n_heads * c.head_dim))
        return out, new_kv


class MLP(nn.Module):
    def __init__(self, cfg: LLMConfig, device=None):
        super().__init__()
        self.cfg = c = cfg
        for name, fin, fout in (
            ("gate_proj", c.d_model, c.ffn_dim),
            ("up_proj", c.d_model, c.ffn_dim),
            ("down_proj", c.ffn_dim, c.d_model),
        ):
            setattr(self, name, _dense(c, name, fin, fout, False, device))

    def forward(self, x: torch.Tensor, tape: Optional[Tape] = None) -> torch.Tensor:
        xq = _shared_quant(self.cfg, x)  # one K2 for gate and up
        gate = self.gate_proj(x, tape, DENSE_SITES["gate_proj"], xq)
        up = self.up_proj(x, tape, DENSE_SITES["up_proj"], xq)
        return self.down_proj(F.silu(gate) * up, tape, DENSE_SITES["down_proj"])


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LLMConfig, device=None):
        super().__init__()
        c = cfg
        self.input_norm = RMSNorm(c.d_model, c.rms_eps, c.dtype, device)
        self.attn = Attention(c, device)
        self.post_attn_norm = RMSNorm(c.d_model, c.rms_eps, c.dtype, device)
        self.mlp = MLP(c, device)

    def forward(self, x, positions, tape: Optional[Tape] = None, **attn_kwargs):
        attn_out, new_kv = self.attn(self.input_norm(x), positions, tape=tape, **attn_kwargs)
        x = x + attn_out
        x = x + self.mlp(self.post_attn_norm(x), tape)
        return x, new_kv


class CausalLM(nn.Module):
    """Embedding + decoder stack + head. Consumes ids or pre-spliced embeds."""

    def __init__(self, cfg: LLMConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        if c.peft_method not in ("lora", "none"):
            raise NotImplementedError(
                f"peft_method {c.peft_method!r} is not ported yet (only lora)"
            )
        self.embed_tokens = nn.Embedding(c.vocab_size, c.d_model, dtype=c.dtype, device=device)
        self.embed_tokens.requires_grad_(False)
        self.layers = nn.ModuleList(DecoderLayer(c, device) for _ in range(c.n_layers))
        self.final_norm = RMSNorm(c.d_model, c.rms_eps, c.dtype, device)
        if not c.tied_embeddings:
            self.lm_head = DenseGeneralLora(
                c.d_model, c.head_size or c.vocab_size, dtype=c.dtype, device=device
            )
        elif c.head_size:
            raise ValueError("head_size requires an untied lm_head")
        if c.ce_quant not in ("none", "int8", "int8_sr"):
            raise ValueError(f"unknown ce_quant {c.ce_quant!r}: expected none, int8 or int8_sr")
        if c.ce_quant != "none":
            # the int8 head of the fused CE, derived from the frozen head by
            # ops.quant.quantize_base_params and never loaded
            v = c.head_size or c.vocab_size
            for name, shape, dtype in (("head_q", (v, c.d_model), torch.int8), ("head_scale", (v,), torch.float32),
                                       ("head_qt", (c.d_model, v), torch.int8)):
                self.register_buffer(name, torch.zeros(shape, dtype=dtype, device=device), persistent=False)
        self.ce_seed = 0  # uint32 seed of the int8_sr CE head's dx, set fresh per step by the trainer

    def head_weight(self) -> torch.Tensor:
        """The (V, D) head: ``lm_head.weight`` or the tied embedding table."""
        return self.embed_tokens.weight if self.cfg.tied_embeddings else self.lm_head.weight

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids).to(self.cfg.dtype)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tied_embeddings:
            logits = F.linear(x.to(self.cfg.dtype), self.embed_tokens.weight.to(self.cfg.dtype))
        else:
            logits = self.lm_head(x)
        return logits.float()

    def trunk(self, inputs_embeds, attention_mask, positions=None) -> torch.Tensor:
        """Decoder stack + final norm without the head."""
        if positions is None:
            positions = _positions_from_mask(attention_mask)
        x = inputs_embeds.to(self.cfg.dtype)
        if self.cfg.remat and torch.is_grad_enabled():
            names = policy_names(self.cfg.remat_policy)
            for layer in self.layers:
                x = checkpoint_layer(layer, names, x, positions, attention_mask)
        else:
            for layer in self.layers:
                x, _ = layer(x, positions, kv_mask=attention_mask)
        return self.final_norm(x)

    def forward(self, inputs_embeds, attention_mask, positions=None) -> torch.Tensor:
        return self._head(self.trunk(inputs_embeds, attention_mask, positions))

    def loss_and_accuracy(
        self,
        inputs_embeds: torch.Tensor,  # (B, T, D)
        attention_mask: torch.Tensor,  # (B, T)
        labels: torch.Tensor,  # (B, T) with -100 on ignored positions
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Shifted CE + next-token accuracy without the (B, T, V) logits: the
        head is fused into a chunked CE (``ops.fused_ce``) whose head gradient
        is formed only when the head trains; ``ce_quant`` runs the int8 head."""
        from slam_llm_tpu_torch.ops.fused_ce import QuantHead, fused_linear_ce

        x = self.trunk(inputs_embeds, attention_mask)
        kernel = self.head_weight()  # (V, D)
        head = None
        if self.cfg.ce_quant != "none":
            head = QuantHead(self.head_q, self.head_scale, self.head_qt, self.cfg.ce_quant == "int8_sr", self.ce_seed)
        return fused_linear_ce(
            x[:, :-1], kernel, labels[:, 1:], chunk=self.cfg.ce_chunk,
            kernel_needs_grad=kernel.requires_grad, compute_dtype=self.cfg.dtype, head=head,
        )

    def prefill(
        self,
        inputs_embeds: torch.Tensor,  # (B, T, D) prompt with audio spliced in
        attention_mask: torch.Tensor,  # (B, T)
        cache: KVCache,  # prefix slots >= T
        positions: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, KVCache]:
        """Write the prompt into the cache at offset 0; return (B, T, V) f32 logits."""
        if positions is None:
            positions = _positions_from_mask(attention_mask)
        x = inputs_embeds.to(self.cfg.dtype)
        for i, layer in enumerate(self.layers):
            x, _ = layer(
                x, positions, kv_mask=attention_mask, cache_k=cache["k"][i], cache_v=cache["v"][i]
            )
        return self._head(self.final_norm(x)), cache

    def decode_step(
        self,
        token_embeds: torch.Tensor,  # (B, 1, D)
        cache: KVCache,
        cache_index: int,  # absolute slot this token is written to
        attention_mask: torch.Tensor,  # (B, max_len) valid slots, this one included
        positions: torch.Tensor,  # (B, 1)
    ) -> Tuple[torch.Tensor, KVCache]:
        bias = make_padding_bias(attention_mask, q_len=1)
        slot = cache_index - cache["k"].shape[2]
        x = token_embeds.to(self.cfg.dtype)
        for i, layer in enumerate(self.layers):
            x, (nk, nv) = layer(
                x, positions, bias=bias, cache_k=cache["k"][i], cache_v=cache["v"][i],
                gen_k=cache["k_gen"][i], gen_v=cache["v_gen"][i], cache_index=cache_index,
            )
            cache["k_gen"][i, :, slot] = nk[:, 0]
            cache["v_gen"][i, :, slot] = nv[:, 0]
        return self._head(self.final_norm(x)), cache


def _positions_from_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """Left-padding-safe positions: cumsum over the mask (pads clamp to 0)."""
    return (attention_mask.to(torch.int64).cumsum(-1) - 1).clamp_min(0)
