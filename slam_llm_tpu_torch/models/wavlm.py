"""WavLM / HuBERT / emotion2vec raw-waveform encoders.

Counterpart of ``slam_llm_tpu/models/wavlm.py``, with the same presets and
numerics:

* a conv feature extractor (bias-free VALID convs, 320x downsample for the
  published stacks): "group" mode is a per-channel instance norm in f32 after
  conv 0 only, "layer" mode a LayerNorm after every conv; exact GELU;
* the feature projection (LayerNorm, then a dense to ``d_model``), padded
  frames zeroed, and the grouped positional conv (``pad = k // 2``, the last
  frame dropped for an even kernel, exact GELU) added;
* pre-LN ("large", ``do_stable_layer_norm``) or post-LN ("base", with the
  ``deep_norm`` residual scale) transformer layers, walked in a loop where
  the reference scans a stacked layer axis;
* WavLM's gated relative position bias: the T5-bucketed ``rel_attn_embed``
  table gathered once into an (H, T, T) f32 bias shared by every layer, gated
  per layer, head and query position by a sigmoid of the hidden state (or of
  the projected query, ``gate_from_query``). HuBERT and emotion2vec are the
  same network without it.

Attention routing follows the reference: with the rel-pos bias the padding
joins the dense (B, H, T, T) bias, which runs the plain attention (the JAX
package sends every dense bias to XLA); without it the padding stays a
structured ``kv_mask``, which on a CUDA tensor runs the flash kernels (K1
forward, K4 backward).

``convert_wavlm`` maps an HF ``WavLMModel`` / ``HubertModel`` state dict
(torch tensors) onto this module's ``state_dict`` names, folding the
positional conv's weight norm from either key form; ``convert_hubert_fairseq``
renames a fairseq HuBERT checkpoint into the HF schema first.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from slam_llm_tpu_torch.models.layers import NEG_INF, DenseGeneralLora, LayerNorm, mha_attention


@dataclass(frozen=True)
class WavLMConfig:
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    ffn_dim: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    feat_extract_norm: str = "group"  # group (base) | layer (large)
    do_stable_layer_norm: bool = False  # True for *-large
    conv_pos: int = 128
    conv_pos_groups: int = 16
    num_buckets: int = 320
    max_distance: int = 800
    rel_bias: bool = True  # False -> HuBERT
    deep_norm: bool = False  # residual * (2L)^(1/4) before post-LN
    gate_from_query: bool = False  # gate the rel-pos bias from q, not from x
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def wavlm_base() -> "WavLMConfig":
        return WavLMConfig()

    @staticmethod
    def wavlm_large() -> "WavLMConfig":
        return WavLMConfig(d_model=1024, n_heads=16, n_layers=24, ffn_dim=4096, feat_extract_norm="layer",
                           do_stable_layer_norm=True)

    @staticmethod
    def hubert_base() -> "WavLMConfig":
        return WavLMConfig(rel_bias=False)

    @staticmethod
    def hubert_large() -> "WavLMConfig":
        return WavLMConfig(d_model=1024, n_heads=16, n_layers=24, ffn_dim=4096, feat_extract_norm="layer",
                           do_stable_layer_norm=True, rel_bias=False)

    @staticmethod
    def hubert_xlarge() -> "WavLMConfig":
        return WavLMConfig(d_model=1280, n_heads=16, n_layers=48, ffn_dim=5120, feat_extract_norm="layer",
                           do_stable_layer_norm=True, rel_bias=False)

    @staticmethod
    def emotion2vec_base() -> "WavLMConfig":
        """data2vec2-audio architecture (emotion2vec checkpoints): conv
        frontend + pre-LN transformer, no relative bias."""
        return WavLMConfig(d_model=768, n_heads=12, n_layers=12, ffn_dim=3072, feat_extract_norm="layer",
                           do_stable_layer_norm=True, rel_bias=False)

    @staticmethod
    def tiny_test(rel_bias: bool = True) -> "WavLMConfig":
        return WavLMConfig(d_model=32, n_heads=2, n_layers=2, ffn_dim=64, conv_dim=(16, 16), conv_kernel=(10, 3),
                           conv_stride=(5, 2), conv_pos=16, conv_pos_groups=2, num_buckets=32, max_distance=50,
                           rel_bias=rel_bias)


WAVLM_PRESETS = {
    "wavlm-base": WavLMConfig.wavlm_base,
    "wavlm-large": WavLMConfig.wavlm_large,
    "hubert-base": WavLMConfig.hubert_base,
    "hubert-large": WavLMConfig.hubert_large,
    "hubert-xlarge": WavLMConfig.hubert_xlarge,
    "emotion2vec-base": WavLMConfig.emotion2vec_base,
    "wavlm-tiny-test": WavLMConfig.tiny_test,
}


def feature_lengths(n_samples, cfg: WavLMConfig):
    """Conv-stack output length of ``n_samples`` (an int or an integer
    tensor): ``(L - k) // s + 1`` per conv, integer floor division."""
    length = n_samples
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        length = (length - k) // s + 1
    return length


def relative_position_buckets(t: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """T5 / WavLM bidirectional bucketing of relative positions, (T, T) int32."""
    ctx = np.arange(t)[:, None]
    mem = np.arange(t)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = (
        max_exact
        + (np.log(np.maximum(rel, 1) / max_exact) / math.log(max_distance / max_exact) * (nb - max_exact))
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets += np.where(is_small, rel, large)
    return buckets.astype(np.int32)


@functools.lru_cache(maxsize=8)
def _buckets(t: int, num_buckets: int, max_distance: int, device: torch.device) -> torch.Tensor:
    """The (T, T) bucket table, made once per length on the device it indexes on."""
    return torch.from_numpy(relative_position_buckets(t, num_buckets, max_distance)).long().to(device)


def _frozen_conv(c_in: int, c_out: int, k: int, dtype, device, **kw) -> nn.Conv1d:
    conv = nn.Conv1d(c_in, c_out, k, dtype=dtype, device=device, **kw)
    return conv.requires_grad_(False)


class ConvFeatureExtractor(nn.Module):
    """waveform (B, S) -> features (B, T, conv_dim[-1])."""

    def __init__(self, cfg: WavLMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c_in = 1
        for i, (dim, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)):
            setattr(self, f"conv_{i}", _frozen_conv(c_in, dim, k, cfg.dtype, device, stride=s, bias=False))
            if cfg.feat_extract_norm == "layer":
                setattr(self, f"ln_{i}", LayerNorm(dim, cfg.layer_norm_eps, cfg.dtype, device))
            c_in = dim
        if cfg.feat_extract_norm == "group":
            self.gn_scale = nn.Parameter(torch.ones(cfg.conv_dim[0], device=device), requires_grad=False)
            self.gn_bias = nn.Parameter(torch.zeros(cfg.conv_dim[0], device=device), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        h = x.to(c.dtype)[:, None, :]  # (B, 1, S): channels first for conv1d
        for i in range(len(c.conv_dim)):
            conv = getattr(self, f"conv_{i}")
            h = F.conv1d(h, conv.weight.to(c.dtype), None, conv.stride)
            if c.feat_extract_norm == "group" and i == 0:
                # GroupNorm(num_groups=dim): a per-channel instance norm over time, in f32
                h32 = h.float()
                mean = h32.mean(-1, keepdim=True)
                var = (h32 - mean).square().mean(-1, keepdim=True)
                h32 = (h32 - mean) * torch.rsqrt(var + 1e-5)
                h = (h32 * self.gn_scale.float()[:, None] + self.gn_bias.float()[:, None]).to(c.dtype)
            elif c.feat_extract_norm == "layer":
                h = getattr(self, f"ln_{i}")(h.transpose(1, 2)).transpose(1, 2)
            h = F.gelu(h, approximate="none")
        return h.transpose(1, 2)


class PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: WavLMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.conv = _frozen_conv(cfg.d_model, cfg.d_model, cfg.conv_pos, cfg.dtype, device,
                                 padding=cfg.conv_pos // 2, groups=cfg.conv_pos_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, conv = self.cfg, self.conv
        h = F.conv1d(x.to(c.dtype).transpose(1, 2), conv.weight.to(c.dtype), conv.bias.to(c.dtype),
                     padding=conv.padding, groups=conv.groups)
        if c.conv_pos % 2 == 0:
            h = h[..., :-1]  # HF removes one trailing frame for even kernels
        return F.gelu(h, approximate="none").transpose(1, 2)


class WavLMSelfAttention(nn.Module):
    """MHA with the optional gated relative position bias."""

    def __init__(self, cfg: WavLMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.d_model // cfg.n_heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, DenseGeneralLora(d, d, use_bias=True, dtype=cfg.dtype, device=device))
        if cfg.rel_bias:
            self.gru_rel_pos_linear = DenseGeneralLora(hd, 8, use_bias=True, dtype=cfg.dtype, device=device)
            self.gru_rel_pos_const = nn.Parameter(torch.ones(1, cfg.n_heads, 1, 1, device=device),
                                                  requires_grad=False)

    def forward(self, x, key_mask_bias, position_bias, kv_mask=None):
        c = self.cfg
        b, t, _ = x.shape
        h, hd = c.n_heads, c.d_model // c.n_heads
        q = self.q_proj(x).reshape(b, t, h, hd)
        k = self.k_proj(x).reshape(b, t, h, hd)
        v = self.v_proj(x).reshape(b, t, h, hd)
        bias = key_mask_bias  # (B, 1, T, T) f32 or None
        if position_bias is not None:
            # linear(hd -> 8) -> (..., 2, 4).sum(-1) -> sigmoid -> gate_a / gate_b
            gate_in = q if c.gate_from_query else x.reshape(b, t, h, hd)
            proj = self.gru_rel_pos_linear(gate_in).reshape(b, t, h, 2, 4).sum(-1)  # (B, T, H, 2)
            gates = torch.sigmoid(proj.float())
            gate_a, gate_b = gates[..., 0].transpose(1, 2), gates[..., 1].transpose(1, 2)  # (B, H, T)
            const = self.gru_rel_pos_const[0, :, 0, 0].float()[None, :, None]
            gate = gate_a * (gate_b * const - 1.0) + 2.0
            gated = gate[..., None] * position_bias[None]  # (B, H, T, T)
            bias = gated if bias is None else bias + gated
        if bias is None:
            out = mha_attention(q, k, v, kv_mask=kv_mask)
        else:
            out = mha_attention(q, k, v, bias=bias)
        return self.out_proj(out.reshape(b, t, c.d_model))


class WavLMLayer(nn.Module):
    def __init__(self, cfg: WavLMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_model, cfg.dtype
        self.attention = WavLMSelfAttention(cfg, device)
        self.layer_norm = LayerNorm(d, cfg.layer_norm_eps, dt, device)
        self.final_layer_norm = LayerNorm(d, cfg.layer_norm_eps, dt, device)
        self.fc1 = DenseGeneralLora(d, cfg.ffn_dim, use_bias=True, dtype=dt, device=device)
        self.fc2 = DenseGeneralLora(cfg.ffn_dim, d, use_bias=True, dtype=dt, device=device)

    def _ffn(self, h):
        return self.fc2(F.gelu(self.fc1(h), approximate="none"))

    def forward(self, x, key_mask_bias, position_bias, kv_mask=None):
        c = self.cfg
        if c.do_stable_layer_norm:  # pre-LN (large)
            x = x + self.attention(self.layer_norm(x), key_mask_bias, position_bias, kv_mask)
            return x + self._ffn(self.final_layer_norm(x))
        alpha = (2.0 * c.n_layers) ** 0.25 if c.deep_norm else 1.0  # post-LN (base)
        x = self.layer_norm(x * alpha + self.attention(x, key_mask_bias, position_bias, kv_mask))
        return self.final_layer_norm(x * alpha + self._ffn(x))


class WavLMEncoder(nn.Module):
    """(B, S) waveform + (B, S) mask -> (B, T, d_model) + the (B, T) mask."""

    def __init__(self, cfg: WavLMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt, eps = cfg.d_model, cfg.dtype, cfg.layer_norm_eps
        self.feature_extractor = ConvFeatureExtractor(cfg, device)
        self.fp_ln = LayerNorm(cfg.conv_dim[-1], eps, dt, device)
        self.fp_proj = DenseGeneralLora(cfg.conv_dim[-1], d, use_bias=True, dtype=dt, device=device)
        self.pos_conv = PositionalConvEmbedding(cfg, device)
        self.encoder_ln = LayerNorm(d, eps, dt, device)
        self.layers = nn.ModuleList(WavLMLayer(cfg, device) for _ in range(cfg.n_layers))
        self.rel_attn_embed = (
            nn.Parameter(torch.zeros(cfg.num_buckets, cfg.n_heads, device=device), requires_grad=False)
            if cfg.rel_bias else None
        )

    def forward(self, audio: torch.Tensor, audio_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        feats = self.feature_extractor(audio)
        b, t, _ = feats.shape
        if audio_mask is None:
            out_mask = torch.ones(b, t, dtype=torch.int32, device=feats.device)
        else:
            lengths = feature_lengths(audio_mask.long().sum(1), c)
            out_mask = (torch.arange(t, device=feats.device)[None, :] < lengths[:, None]).to(torch.int32)

        h = self.fp_proj(self.fp_ln(feats))
        h = h * out_mask[..., None].to(h.dtype)  # padded frames zeroed (HF parity)
        h = h + self.pos_conv(h)
        if not c.do_stable_layer_norm:
            h = self.encoder_ln(h)

        key_mask_bias = None
        kv_mask = out_mask if audio_mask is not None else None
        if audio_mask is not None and c.rel_bias:
            # the rel-pos presets merge padding into the dense bias; the plain
            # presets keep the structured kv_mask, which the flash kernels take
            valid = out_mask[:, None, None, :].bool().expand(b, 1, t, t)
            key_mask_bias = torch.where(valid, 0.0, NEG_INF).float()
        position_bias = None
        if c.rel_bias:
            buckets = _buckets(t, c.num_buckets, c.max_distance, feats.device)
            position_bias = self.rel_attn_embed[buckets].permute(2, 0, 1).float()  # (H, T, T)
        for layer in self.layers:
            h = layer(h, key_mask_bias, position_bias, kv_mask)
        if c.do_stable_layer_norm:
            h = self.encoder_ln(h)
        return h, out_mask


# ---------------------------------------------------------------------------
# checkpoint conversion
# ---------------------------------------------------------------------------


def convert_hubert_fairseq(sd: Dict[str, torch.Tensor], cfg: WavLMConfig) -> Dict[str, torch.Tensor]:
    """A fairseq HuBERT checkpoint (``{"model": sd}`` or the state dict) ->
    ``WavLMEncoder`` names: its keys renamed into the HF schema, then
    ``convert_wavlm``; the pretraining heads are skipped."""
    if "model" in sd and not any("." in k for k in list(sd)[:3] if isinstance(k, str)):
        sd = sd["model"]
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k.startswith(("label_embs", "final_proj", "mask_emb")):
            continue
        nk = k
        if k.startswith("feature_extractor.conv_layers."):
            parts = k.split(".")
            i, slot = parts[2], parts[3]
            if slot == "0":
                nk = f"feature_extractor.conv_layers.{i}.conv.{parts[-1]}"
            elif slot == "2":  # group-norm mode: .2.{weight,bias}; layer-norm mode: .2.1.{...}
                nk = f"feature_extractor.conv_layers.{i}.layer_norm.{parts[-1]}"
        elif k in ("layer_norm.weight", "layer_norm.bias"):
            nk = "feature_projection." + k
        elif k.startswith("post_extract_proj."):
            nk = k.replace("post_extract_proj.", "feature_projection.projection.")
        elif k.startswith("encoder.pos_conv.0."):
            nk = k.replace("encoder.pos_conv.0.", "encoder.pos_conv_embed.conv.")
        elif k.startswith("encoder.layers."):
            nk = (k.replace(".self_attn.", ".attention.").replace(".self_attn_layer_norm.", ".layer_norm.")
                  .replace(".fc1.", ".feed_forward.intermediate_dense.")
                  .replace(".fc2.", ".feed_forward.output_dense."))
        out[nk] = torch.as_tensor(v)
    return convert_wavlm(out, cfg)


def fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``g * v / ||v||`` in f32, the norm over every axis but the last (torch
    ``weight_norm`` with ``dim=2`` on a conv1d weight (out, in / groups, k))."""
    g, v = g.float(), v.float()
    norm = v.square().sum(dim=(0, 1), keepdim=True).sqrt()
    return g * v / norm.clamp_min(1e-12)


def convert_wavlm(sd: Dict[str, torch.Tensor], cfg: WavLMConfig) -> Dict[str, torch.Tensor]:
    """HF ``WavLMModel`` / ``HubertModel`` state dict (bare, ``wavlm.`` or
    ``hubert.`` prefixed) -> ``WavLMEncoder`` ``state_dict`` names. HF's
    (out, in) dense and (out, in / groups, k) conv layouts are the port's
    own; the positional conv's weight norm is folded from ``weight_g`` /
    ``weight_v`` or ``parametrizations.weight.original0`` / ``original1``."""
    pre = "wavlm." if any(k.startswith("wavlm.") for k in sd) else (
        "hubert." if any(k.startswith("hubert.") for k in sd) else "")
    out: Dict[str, torch.Tensor] = {}

    def take(dst: str, src: str) -> None:
        out[dst] = torch.as_tensor(sd[pre + src])

    def norm(dst: str, src: str) -> None:
        take(f"{dst}.scale", f"{src}.weight")
        take(f"{dst}.bias", f"{src}.bias")

    def dense(dst: str, src: str) -> None:
        take(f"{dst}.weight", f"{src}.weight")
        take(f"{dst}.bias", f"{src}.bias")

    fe = "feature_extractor.conv_layers."
    for i in range(len(cfg.conv_dim)):
        take(f"feature_extractor.conv_{i}.weight", f"{fe}{i}.conv.weight")
        if cfg.feat_extract_norm == "layer":
            norm(f"feature_extractor.ln_{i}", f"{fe}{i}.layer_norm")
    if cfg.feat_extract_norm == "group":
        take("feature_extractor.gn_scale", f"{fe}0.layer_norm.weight")
        take("feature_extractor.gn_bias", f"{fe}0.layer_norm.bias")

    base = pre + "encoder.pos_conv_embed.conv."
    if base + "weight" in sd:
        out["pos_conv.conv.weight"] = torch.as_tensor(sd[base + "weight"])
    else:
        p = base + "parametrizations.weight.original"
        g, v = (sd[p + "0"], sd[p + "1"]) if p + "0" in sd else (sd[base + "weight_g"], sd[base + "weight_v"])
        out["pos_conv.conv.weight"] = fold_weight_norm(torch.as_tensor(g), torch.as_tensor(v))
    take("pos_conv.conv.bias", "encoder.pos_conv_embed.conv.bias")

    norm("fp_ln", "feature_projection.layer_norm")
    dense("fp_proj", "feature_projection.projection")
    norm("encoder_ln", "encoder.layer_norm")
    for i in range(cfg.n_layers):
        src, dst = f"encoder.layers.{i}.", f"layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{dst}attention.{name}", f"{src}attention.{name}")
        norm(f"{dst}layer_norm", f"{src}layer_norm")
        norm(f"{dst}final_layer_norm", f"{src}final_layer_norm")
        dense(f"{dst}fc1", f"{src}feed_forward.intermediate_dense")
        dense(f"{dst}fc2", f"{src}feed_forward.output_dense")
        if cfg.rel_bias:
            dense(f"{dst}attention.gru_rel_pos_linear", f"{src}attention.gru_rel_pos_linear")
            take(f"{dst}attention.gru_rel_pos_const", f"{src}attention.gru_rel_pos_const")
    if cfg.rel_bias:
        take("rel_attn_embed", "encoder.layers.0.attention.rel_attn_embed.weight")
    return out
