"""BEATs audio encoder: a WavLM-style transformer over fbank patches.

Counterpart of ``slam_llm_tpu/models/beats.py``, with the same presets and
numerics (the reference's in-tree BEATs, ``models/BEATs/BEATs.py`` and
``backbone.py``):

* a bias-free Conv2d patch embedding (16 x 16, stride 16) over the 128-bin
  Kaldi fbank, flattened time-major with the frequency patch fastest, then
  a LayerNorm and a 512 -> 768 projection;
* padded features zeroed, the grouped positional conv added and
  ``encoder_ln`` applied BEFORE the stack;
* one ``rel_attn_embed`` table gathered into an (H, T, T) f32 bias shared by
  every layer, and the port's ``WavLMLayer`` with ``deep_norm`` (post-LN,
  residual x (2L)^(1/4)) and the rel-pos gate computed from the projected
  query (``gate_from_query``).

The padding joins the dense (B, H, T, T) bias, so the attention runs the
plain path on every device, as the JAX package sends every dense bias to
XLA. ``convert_beats`` maps an official BEATs checkpoint's state dict
(torch tensors) onto this module's ``state_dict`` names.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from slam_llm_tpu_torch.models.layers import NEG_INF, DenseGeneralLora, LayerNorm
from slam_llm_tpu_torch.models.vit import conv_patches, frozen_conv2d
from slam_llm_tpu_torch.models.wavlm import (
    PositionalConvEmbedding,
    WavLMConfig,
    WavLMLayer,
    _buckets,
    fold_weight_norm,
)


@dataclass(frozen=True)
class BEATsEncoderConfig:
    patch_size: int = 16
    patch_embed_dim: int = 512
    n_mels: int = 128
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    ffn_dim: int = 3072
    num_buckets: int = 320
    max_distance: int = 1280
    conv_pos: int = 128
    conv_pos_groups: int = 16
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    def layer_cfg(self) -> WavLMConfig:
        return WavLMConfig(
            d_model=self.d_model, n_heads=self.n_heads, n_layers=self.n_layers, ffn_dim=self.ffn_dim,
            num_buckets=self.num_buckets, max_distance=self.max_distance, rel_bias=True,
            deep_norm=True, gate_from_query=True, do_stable_layer_norm=False,
            conv_pos=self.conv_pos, conv_pos_groups=self.conv_pos_groups, layer_norm_eps=self.layer_norm_eps,
            dtype=self.dtype,
        )

    @staticmethod
    def beats_iter3() -> "BEATsEncoderConfig":
        return BEATsEncoderConfig()

    @staticmethod
    def tiny_test() -> "BEATsEncoderConfig":
        return BEATsEncoderConfig(
            patch_size=4, patch_embed_dim=8, n_mels=16, d_model=32, n_heads=2, n_layers=2, ffn_dim=64,
            num_buckets=32, max_distance=64, conv_pos=16, conv_pos_groups=2,
        )


BEATS_PRESETS = {
    "beats-iter3": BEATsEncoderConfig.beats_iter3,
    "beats-tiny-test": BEATsEncoderConfig.tiny_test,
}


def beats_patch_mask(mel_mask: torch.Tensor, n_features: int) -> torch.Tensor:
    """The reference's ``forward_padding_mask``: T truncated to a multiple of
    ``n_features`` and split into that many chunks; a feature is valid
    unless every frame of its chunk is padding. The chunks are not the
    patches' frames: the grouping is the reference's, kept as it is."""
    b, t = mel_mask.shape
    group = t // n_features
    grouped = mel_mask[:, : group * n_features].reshape(b, n_features, group)
    return grouped.amax(-1).to(torch.int32)


class BEATsTransformer(nn.Module):
    """Zero the padded features, add the positional conv, ``encoder_ln``,
    then the deep-norm layers with the shared gated rel-pos bias."""

    def __init__(self, cfg: BEATsEncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        lc = cfg.layer_cfg()
        self.pos_conv = PositionalConvEmbedding(lc, device)
        self.encoder_ln = LayerNorm(cfg.d_model, cfg.layer_norm_eps, cfg.dtype, device)
        self.rel_attn_embed = nn.Parameter(torch.zeros(cfg.num_buckets, cfg.n_heads, device=device),
                                           requires_grad=False)
        self.layers = nn.ModuleList(WavLMLayer(lc, device) for _ in range(cfg.n_layers))

    def forward(self, x: torch.Tensor, out_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        b, n, _ = x.shape
        key_mask_bias = None
        if out_mask is not None:
            x = x * out_mask[..., None].to(x.dtype)
            valid = out_mask[:, None, None, :].bool().expand(b, 1, n, n)
            key_mask_bias = torch.where(valid, 0.0, NEG_INF).float()
        x = self.encoder_ln(x + self.pos_conv(x))
        buckets = _buckets(n, c.num_buckets, c.max_distance, x.device)
        position_bias = self.rel_attn_embed[buckets].permute(2, 0, 1).float()  # (H, T, T)
        for layer in self.layers:
            x = layer(x, key_mask_bias, position_bias)
        return x


class BEATsEncoder(nn.Module):
    """(B, T_mel, 128) normalized fbank + (B, T_mel) mask -> (B, T/16 * 8,
    d_model) + the (B, T/16 * 8) feature mask."""

    def __init__(self, cfg: BEATsEncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        self.patch_embedding = frozen_conv2d(1, cfg.patch_embed_dim, cfg.patch_size, False, dt, device)
        self.layer_norm = LayerNorm(cfg.patch_embed_dim, cfg.layer_norm_eps, dt, device)
        self.post_extract_proj = DenseGeneralLora(cfg.patch_embed_dim, cfg.d_model, use_bias=True, dtype=dt,
                                                  device=device)
        self.transformer = BEATsTransformer(cfg, device)

    def forward(self, fbank: torch.Tensor, mel_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x, tp, fp = conv_patches(self.patch_embedding, fbank, self.cfg.dtype)
        x = self.post_extract_proj(self.layer_norm(x))
        if mel_mask is None:
            out_mask = torch.ones(x.shape[:2], dtype=torch.int32, device=x.device)
            return self.transformer(x), out_mask
        out_mask = beats_patch_mask(mel_mask, tp * fp)
        return self.transformer(x, out_mask), out_mask


def convert_beats(sd: Dict[str, torch.Tensor], cfg: BEATsEncoderConfig) -> Dict[str, torch.Tensor]:
    """An official BEATs checkpoint's ``model`` state dict -> ``BEATsEncoder``
    ``state_dict`` names (torch's layouts are the port's own). The positional
    conv's weight norm is folded in f32 from ``weight_g`` / ``weight_v`` or
    ``parametrizations.weight.original0`` / ``original1``; the gate keys
    (``grep_linear``, ``grep_a``) and the rel-pos table are taken where the
    checkpoint has them (a tokenizer checkpoint lacks them)."""
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {
        "patch_embedding.weight": sd["patch_embedding.weight"],
        "layer_norm.scale": sd["layer_norm.weight"],
        "layer_norm.bias": sd["layer_norm.bias"],
        "post_extract_proj.weight": sd["post_extract_proj.weight"],
        "post_extract_proj.bias": sd["post_extract_proj.bias"],
    }
    base, t = "encoder.pos_conv.0.", "transformer."
    if base + "weight" in sd:
        out[t + "pos_conv.conv.weight"] = sd[base + "weight"]
    else:
        p = base + "parametrizations.weight.original"
        g, v = (sd[p + "0"], sd[p + "1"]) if p + "0" in sd else (sd[base + "weight_g"], sd[base + "weight_v"])
        out[t + "pos_conv.conv.weight"] = fold_weight_norm(g, v)
    out[t + "pos_conv.conv.bias"] = sd[base + "bias"]
    out[t + "encoder_ln.scale"] = sd["encoder.layer_norm.weight"]
    out[t + "encoder_ln.bias"] = sd["encoder.layer_norm.bias"]
    for i in range(cfg.n_layers):
        src, dst = f"encoder.layers.{i}.", f"{t}layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out[f"{dst}attention.{name}.weight"] = sd[f"{src}self_attn.{name}.weight"]
            out[f"{dst}attention.{name}.bias"] = sd[f"{src}self_attn.{name}.bias"]
        for port, ref in (("layer_norm", "self_attn_layer_norm"), ("final_layer_norm", "final_layer_norm")):
            out[f"{dst}{port}.scale"] = sd[f"{src}{ref}.weight"]
            out[f"{dst}{port}.bias"] = sd[f"{src}{ref}.bias"]
        for name in ("fc1", "fc2"):
            out[f"{dst}{name}.weight"] = sd[f"{src}{name}.weight"]
            out[f"{dst}{name}.bias"] = sd[f"{src}{name}.bias"]
        if src + "self_attn.grep_linear.weight" in sd:
            out[f"{dst}attention.gru_rel_pos_linear.weight"] = sd[src + "self_attn.grep_linear.weight"]
            out[f"{dst}attention.gru_rel_pos_linear.bias"] = sd[src + "self_attn.grep_linear.bias"]
            out[f"{dst}attention.gru_rel_pos_const"] = sd[src + "self_attn.grep_a"]
    rel_key = "encoder.layers.0.self_attn.relative_attention_bias.weight"
    if rel_key in sd:
        out[t + "rel_attn_embed"] = sd[rel_key]
    return out
