"""Audio-spectrogram ViT: the EAT encoder.

Counterpart of ``slam_llm_tpu/models/vit.py`` (its EAT half), with the same
presets and numerics. EAT is a data2vec-2.0 image-mode ViT over the 128-bin
Kaldi fbank "image":

* a Conv2d patch embedding (16 x 16, stride 16) over ``(B, 1, T, F)``,
  flattened time-major with the frequency patch fastest;
* the fixed 2-D sin-cos table added (``sincos_2d_positions``), then the CLS
  token prepended (EAT keeps it: ``remove_extra_tokens=False`` in the
  reference);
* pre-LN blocks: q / k / v / proj with bias, an exact-GELU MLP at ratio 4;
  the padding is a structured key mask, so on a CUDA tensor the attention
  runs the flash kernel (K1);
* the final LayerNorm.

Under tensor parallelism (``parallel.tensor_parallel.split_vit``) a block
runs ``n_heads / tp`` heads a rank: q / k / v and fc1 column-parallel, proj
and fc2 row-parallel.

``convert_eat_fairseq`` maps an EAT fairseq checkpoint (the data2vec2
layout, torch tensors) onto this module's ``state_dict`` names.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from slam_llm_tpu_torch.models.layers import DenseGeneralLora, LayerNorm, mha_attention


@dataclass(frozen=True)
class ViTEncoderConfig:
    patch_size: int = 16
    n_mels: int = 128
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def eat_base() -> "ViTEncoderConfig":
        return ViTEncoderConfig()

    @staticmethod
    def tiny_test() -> "ViTEncoderConfig":
        return ViTEncoderConfig(patch_size=4, n_mels=16, d_model=32, n_heads=2, n_layers=2)


VIT_PRESETS = {
    "eat-base": ViTEncoderConfig.eat_base,
    "eat-tiny-test": ViTEncoderConfig.tiny_test,
}


def sincos_2d_positions(grid_t: int, grid_f: int, dim: int) -> np.ndarray:
    """Fixed 2-D sin-cos table, (grid_t * grid_f, dim) f32, computed in f64:
    the first half of the channels encodes the frequency coordinate, the
    second half the time coordinate (the MAE / data2vec layout)."""
    assert dim % 4 == 0

    def enc_1d(pos, d):
        omega = 1.0 / (10000 ** (np.arange(d // 2, dtype=np.float64) / (d // 2)))
        out = pos[:, None] * omega[None, :]
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    t_pos = np.repeat(np.arange(grid_t), grid_f)
    f_pos = np.tile(np.arange(grid_f), grid_t)
    emb = np.concatenate([enc_1d(f_pos, dim // 2), enc_1d(t_pos, dim // 2)], axis=1)
    return emb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _positions(grid_t: int, grid_f: int, dim: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The table, made once per grid on the device it is added on."""
    return torch.from_numpy(sincos_2d_positions(grid_t, grid_f, dim)).to(device, dtype)


def frozen_conv2d(c_in: int, c_out: int, p: int, bias: bool, dtype, device) -> nn.Conv2d:
    """A p x p, stride p patch embedding, stored in the compute dtype."""
    conv = nn.Conv2d(c_in, c_out, p, stride=p, bias=bias, dtype=dtype, device=device)
    return conv.requires_grad_(False)


def conv_patches(conv: nn.Conv2d, fbank: torch.Tensor, dtype) -> Tuple[torch.Tensor, int, int]:
    """(B, T, F) fbank -> (B, T/p * F/p, C) patches, time-major with the
    frequency patch fastest (flax's NHWC reshape), and the grid."""
    w = conv.weight.to(dtype)
    b = None if conv.bias is None else conv.bias.to(dtype)
    x = F.conv2d(fbank.to(dtype)[:, None], w, b, stride=conv.stride)  # (B, C, T/p, F/p)
    tp, fp = x.shape[2], x.shape[3]
    return x.flatten(2).transpose(1, 2), tp, fp


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTEncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt, eps = cfg.d_model, cfg.dtype, cfg.layer_norm_eps
        self.norm1 = LayerNorm(d, eps, dt, device)
        for name in ("q_proj", "k_proj", "v_proj"):
            setattr(self, name, DenseGeneralLora(d, d, use_bias=True, dtype=dt, device=device))
        self.proj = DenseGeneralLora(d, d, use_bias=True, dtype=dt, device=device)
        self.norm2 = LayerNorm(d, eps, dt, device)
        hidden = int(d * cfg.mlp_ratio)
        self.fc1 = DenseGeneralLora(d, hidden, use_bias=True, dtype=dt, device=device)
        self.fc2 = DenseGeneralLora(hidden, d, use_bias=True, dtype=dt, device=device)
        self.n_heads = cfg.n_heads  # this rank's heads (n_heads / tp once split)

    def forward(self, x: torch.Tensor, kv_mask: Optional[torch.Tensor]) -> torch.Tensor:
        c = self.cfg
        b, t, _ = x.shape
        nh, hd = self.n_heads, c.d_model // c.n_heads
        h = self.norm1(x)
        q = self.q_proj(h).reshape(b, t, nh, hd)
        k = self.k_proj(h).reshape(b, t, nh, hd)
        v = self.v_proj(h).reshape(b, t, nh, hd)
        x = x + self.proj(mha_attention(q, k, v, kv_mask=kv_mask).reshape(b, t, nh * hd))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="none"))


class ViTEncoder(nn.Module):
    """(B, T_mel, n_mels) fbank + (B, T_mel) mask -> (B, cls + T/p * F/p,
    d_model) + the (B, cls + T/p * F/p) token mask."""

    def __init__(self, cfg: ViTEncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_model, cfg.dtype
        self.patch_embed = frozen_conv2d(1, d, cfg.patch_size, True, dt, device)
        self.cls_token = nn.Parameter(torch.zeros(1, d, device=device), requires_grad=False)
        self.blocks = nn.ModuleList(ViTBlock(cfg, device) for _ in range(cfg.n_layers))
        self.norm = LayerNorm(d, cfg.layer_norm_eps, dt, device)

    def forward(self, fbank: torch.Tensor, mel_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        b, p = fbank.shape[0], c.patch_size
        x, tp, fp = conv_patches(self.patch_embed, fbank, c.dtype)
        x = x + _positions(tp, fp, c.d_model, x.device, c.dtype)[None]
        x = torch.cat([self.cls_token.to(c.dtype).expand(b, 1, c.d_model), x], dim=1)
        if mel_mask is None:
            out_mask = torch.ones(b, x.shape[1], dtype=torch.int32, device=x.device)
            kv_mask = None
        else:
            patch_valid = mel_mask[:, : tp * p].reshape(b, tp, p).amax(-1)  # (B, tp)
            out_mask = torch.cat([torch.ones(b, 1, dtype=torch.int32, device=x.device),
                                  patch_valid.repeat_interleave(fp, dim=1).to(torch.int32)], dim=1)
            kv_mask = out_mask
        for block in self.blocks:
            x = block(x, kv_mask)
        return self.norm(x), out_mask


def convert_eat_fairseq(ckpt: Dict[str, Any], cfg: ViTEncoderConfig) -> Dict[str, torch.Tensor]:
    """An EAT fairseq checkpoint (``{"model": sd}`` or the state dict) ->
    ``ViTEncoder`` ``state_dict`` names. The data2vec2 layout:
    ``modality_encoders.IMAGE.local_encoder.proj`` (the patch conv, already
    torch's (C, 1, p, p)), ``modality_encoders.IMAGE.extra_tokens`` (CLS),
    ``blocks.N.attn.qkv`` fused and split here into q / k / v,
    ``blocks.N.{norm1,norm2,attn.proj,mlp.fc1,mlp.fc2}`` and the top-level
    ``norm``; the decoder and the other modalities are skipped."""
    sd = ckpt.get("model", ckpt)
    sd = {k: torch.as_tensor(v) for k, v in sd.items() if hasattr(v, "shape")}
    pre, d = "modality_encoders.IMAGE.", cfg.d_model
    out: Dict[str, torch.Tensor] = {
        "patch_embed.weight": sd[pre + "local_encoder.proj.weight"],
        "patch_embed.bias": sd[pre + "local_encoder.proj.bias"],
        "cls_token": sd[pre + "extra_tokens"].reshape(1, d),
    }
    for i in range(cfg.n_layers):
        src, dst = f"blocks.{i}.", f"blocks.{i}."
        qkv_w, qkv_b = sd[src + "attn.qkv.weight"], sd[src + "attn.qkv.bias"]  # (3D, D), (3D,)
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            out[f"{dst}{name}.weight"] = qkv_w[j * d:(j + 1) * d]
            out[f"{dst}{name}.bias"] = qkv_b[j * d:(j + 1) * d]
        for port, ref in (("proj", "attn.proj"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            out[f"{dst}{port}.weight"] = sd[f"{src}{ref}.weight"]
            out[f"{dst}{port}.bias"] = sd[f"{src}{ref}.bias"]
        for norm in ("norm1", "norm2"):
            out[f"{dst}{norm}.scale"] = sd[f"{src}{norm}.weight"]
            out[f"{dst}{norm}.bias"] = sd[f"{src}{norm}.bias"]
    out["norm.scale"], out["norm.bias"] = sd["norm.weight"], sd["norm.bias"]
    return out
