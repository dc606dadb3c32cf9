"""HTS-AT: the hierarchical token-semantic Swin transformer, CLAP's audio tower.

Counterpart of ``slam_llm_tpu/models/htsat.py`` (inference only, f32, no
dropout or drop-path):

* bn0 over the mel bins (frozen statistics);
* the mel folded into a (spec_size x spec_size) "image" (``reshape_wav2img``:
  a short mel is first stretched to the target length by the bicubic resize
  of ``ops.resize``, then ``freq_ratio`` time strips are stacked along
  frequency);
* a 4 x 4 patch embedding and LayerNorm;
* Swin stages of window attention with the relative-position bias table and,
  in every second block, shifted windows with their additive mask; patch
  merging between stages;
* the token-semantic regroup, whose frequency-mean, repeated
  ``8 * patch_stride`` times along time, is ``fine_grained_embedding`` (the
  tensor CLAP pools), the clip latent, and the tscam head's clip-wise and
  frame-wise outputs.

The window attention is plain torch (head_dim 24, 64 tokens a window and a
dense bias), as the JAX package's is XLA. The module's ``state_dict`` names
are the reference's (``bn0``, ``patch_embed.{proj,norm}``,
``layers.{i}.blocks.{j}.{norm1,attn.qkv,attn.proj,attn.relative_position_bias_table,norm2,mlp.fc1,mlp.fc2}``,
``layers.{i}.downsample.{norm,reduction}``, ``norm``, ``tscam_conv``), so
``convert_htsat_torch_state`` only strips ``sed_model.`` and picks them.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from slam_llm_tpu_torch.models.layers import FrozenBatchNorm, dense_f32, layer_norm_f32, pick_state
from slam_llm_tpu_torch.ops.resize import resize_bicubic_align_corners


@dataclass(frozen=True)
class HTSATConfig:
    spec_size: int = 256
    patch_size: int = 4
    patch_stride: int = 4
    in_chans: int = 1
    num_classes: int = 527
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    n_mels: int = 64
    bn_eps: float = 1e-5

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.n_mels

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))

    @staticmethod
    def tiny_test() -> "HTSATConfig":
        return HTSATConfig(spec_size=32, patch_size=4, patch_stride=4, num_classes=6, embed_dim=8, depths=(1, 1),
                           num_heads=(2, 2), window_size=4, n_mels=8)


def relative_position_index(w: int) -> np.ndarray:
    """(w*w, w*w) indices into the (2w-1)^2 relative-position-bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)


def shift_attn_mask(h: int, w_res: int, window: int, shift: int) -> np.ndarray:
    """(nW, w*w, w*w) additive mask (0 / -100) of the shifted windows."""
    img = np.zeros((h, w_res))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(h // window, window, w_res // window, window).transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _tables(window: int, h: int, w_res: int, shift: int, device: torch.device):
    """The bias-table gather index and (with a shift) the window mask, made
    once per stage shape on the device they are used on."""
    idx = torch.from_numpy(relative_position_index(window).reshape(-1)).to(device)
    mask = torch.from_numpy(shift_attn_mask(h, w_res, window, shift)).to(device) if shift else None
    return idx, mask


def _window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, w * w, C)."""
    b, h, ww, c = x.shape
    return x.reshape(b, h // w, w, ww // w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def _window_reverse(x: torch.Tensor, w: int, h: int, ww: int) -> torch.Tensor:
    b = x.shape[0] // ((h // w) * (ww // w))
    return x.reshape(b, h // w, ww // w, w, w, -1).permute(0, 1, 3, 2, 4, 5).reshape(b, h, ww, -1)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, res: Tuple[int, int], n_heads: int, shift: int, cfg: HTSATConfig, device=None):
        super().__init__()
        self.res, self.n_heads = res, n_heads
        self.window = min(cfg.window_size, min(res))
        self.shift = 0 if min(res) <= cfg.window_size else shift
        hidden = int(dim * cfg.mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, device=device)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.attn.proj = nn.Linear(dim, dim, device=device)
        self.attn.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * self.window - 1) ** 2, n_heads, device=device), requires_grad=False)
        self.norm2 = nn.LayerNorm(dim, device=device)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, hidden, device=device)
        self.mlp.fc2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (h, w_res), win, shift, heads = self.res, self.window, self.shift, self.n_heads
        b, l, dim = x.shape
        n, hd = win * win, dim // heads
        shortcut = x
        x = layer_norm_f32(self.norm1, x).reshape(b, h, w_res, dim)
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        xw = _window_partition(x, win)
        qkv = dense_f32(self.attn.qkv, xw).reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
        attn = torch.einsum("bhnd,bhmd->bhnm", q, k)
        idx, mask = _tables(win, h, w_res, shift, x.device)
        bias = self.attn.relative_position_bias_table.float()[idx].reshape(n, n, heads).permute(2, 0, 1)
        attn = attn + bias[None]
        if shift:
            nw = mask.shape[0]
            attn = (attn.reshape(-1, nw, heads, n, n) + mask[None, :, None]).reshape(-1, heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        xw = torch.einsum("bhnm,bhmd->bhnd", attn, v).transpose(1, 2).reshape(-1, n, dim)
        x = _window_reverse(dense_f32(self.attn.proj, xw), win, h, w_res)
        if shift:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x.reshape(b, l, dim)
        y = F.gelu(dense_f32(self.mlp.fc1, layer_norm_f32(self.norm2, x)), approximate="none")
        return x + dense_f32(self.mlp.fc2, y)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, res: Tuple[int, int], device=None):
        super().__init__()
        self.res = res
        self.norm = nn.LayerNorm(4 * dim, device=device)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w_res = self.res
        b, _, dim = x.shape
        x = x.reshape(b, h, w_res, dim)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return dense_f32(self.reduction, layer_norm_f32(self.norm, x.reshape(b, (h // 2) * (w_res // 2), 4 * dim)))


class HTSAT(nn.Module):
    """mel (B, T, n_mels), T <= spec_size * freq_ratio -> ``embedding`` (B, C),
    ``fine_grained_embedding`` (B, T', C), ``clipwise_output`` (B, classes),
    ``framewise_output`` (B, T', classes), all f32."""

    def __init__(self, cfg: HTSATConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.bn0 = FrozenBatchNorm(c.n_mels, c.bn_eps, device)
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(c.in_chans, c.embed_dim, c.patch_size, stride=c.patch_stride, device=device)
        self.patch_embed.norm = nn.LayerNorm(c.embed_dim, device=device)
        grid = c.spec_size // c.patch_stride
        self.layers = nn.ModuleList()
        for i, depth in enumerate(c.depths):
            dim, res = c.embed_dim * 2 ** i, (grid // 2 ** i, grid // 2 ** i)
            stage = nn.Module()
            stage.blocks = nn.ModuleList(
                SwinBlock(dim, res, c.num_heads[i], 0 if j % 2 == 0 else c.window_size // 2, c, device)
                for j in range(depth))
            if i < len(c.depths) - 1:
                stage.downsample = PatchMerging(dim, res, device)
            self.layers.append(stage)
        self.norm = nn.LayerNorm(c.num_features, device=device)
        cfb = c.spec_size // 2 ** (len(c.depths) - 1) // c.patch_stride // c.freq_ratio
        self.tscam_conv = nn.Conv2d(c.num_features, c.num_classes, (cfb, 3), padding=(0, 1), device=device)

    def reshape_wav2img(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, T, F) mel -> (B, 1, S, S) image."""
        c = self.cfg
        b, ch, t, f = x.shape
        target_t, target_f = c.spec_size * c.freq_ratio, c.spec_size // c.freq_ratio
        if t > target_t or f > target_f:
            raise ValueError(f"mel input ({t}, {f}) exceeds the HTSAT target ({target_t}, {target_f}); crop or "
                             "chunk longer audio")
        if t < target_t or f < target_f:
            x = resize_bicubic_align_corners(x, target_t, max(f, target_f))
        x = x.transpose(2, 3).reshape(b, ch, target_f, c.freq_ratio, target_t // c.freq_ratio)
        return x.transpose(2, 3).reshape(b, ch, c.freq_ratio * target_f, target_t // c.freq_ratio)

    def forward(self, mel: torch.Tensor) -> Dict[str, torch.Tensor]:
        c = self.cfg
        b = mel.shape[0]
        x = self.reshape_wav2img(self.bn0(mel.float())[:, None])
        frames = x.shape[2]
        pe = self.patch_embed.proj
        x = F.conv2d(x, pe.weight.float(), pe.bias.float(), stride=pe.stride)  # (B, C, H, W)
        x = layer_norm_f32(self.patch_embed.norm, x.flatten(2).transpose(1, 2))
        for stage in self.layers:
            for block in stage.blocks:
                x = block(x)
            if hasattr(stage, "downsample"):
                x = stage.downsample(x)
        x = layer_norm_f32(self.norm, x)

        # the token-semantic regroup
        n_feat = c.num_features
        sf = st = frames // 2 ** (len(c.depths) - 1) // c.patch_stride
        x = x.transpose(1, 2).reshape(b, n_feat, sf, st)
        cfb = sf // c.freq_ratio
        x = x.reshape(b, n_feat, sf // cfb, cfb, st).transpose(2, 3).reshape(b, n_feat, cfb, -1)
        fine = x.mean(dim=2).transpose(1, 2).repeat_interleave(8 * c.patch_stride, dim=1)
        latent = x.reshape(b, n_feat, -1).mean(dim=-1)
        tc = self.tscam_conv
        logits_t = F.conv2d(x, tc.weight.float(), tc.bias.float(), padding=tc.padding)[:, :, 0]  # (B, classes, T)
        framewise = torch.sigmoid(logits_t).transpose(1, 2).repeat_interleave(8 * c.patch_stride, dim=1)
        return {"embedding": latent, "fine_grained_embedding": fine,
                "clipwise_output": torch.sigmoid(logits_t.mean(dim=-1)), "framewise_output": framewise}


def convert_htsat_torch_state(sd: Dict[str, torch.Tensor], cfg: HTSATConfig = HTSATConfig()) -> Dict[str, torch.Tensor]:
    """A reference HTSAT state dict (optionally ``sed_model.``-prefixed) ->
    ``HTSAT`` ``state_dict`` names, f32."""
    sd = {k[len("sed_model."):] if k.startswith("sed_model.") else k: v for k, v in sd.items()}
    return pick_state(sd, HTSAT(cfg, device="meta"))
