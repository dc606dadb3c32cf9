"""Cnn14 (PANNs): CLAP's CNN audio tower.

Counterpart of ``slam_llm_tpu/models/cnn14.py`` (inference only, f32): bn0
over the 64 mel bins, six conv blocks (3 x 3 conv without bias, frozen
BatchNorm, ReLU, twice, then a 2 x 2 average pool), and the mean over the
mel axis, giving time-resolved (B, T / 64, 2048) features. The convolutions
are cuDNN's on the card (the JAX package computes them in XLA). The
reference's dropout between blocks is a training-only step this
inference-only tower leaves out, as the JAX package's deterministic forward
does. ``state_dict`` names are the reference's (``bn0.*``,
``conv_block{i}.conv{j}.weight``, ``conv_block{i}.bn{j}.*``), so
``convert_cnn14_torch_state`` only picks them; ResNet38 checkpoints raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from slam_llm_tpu_torch.models.layers import FrozenBatchNorm, pick_state


@dataclass(frozen=True)
class Cnn14Config:
    mel_bins: int = 64
    base_channels: int = 64  # block channels: base * (1, 2, 4, 8, 16, 32)

    @property
    def out_dim(self) -> int:
        return self.base_channels * 32

    @staticmethod
    def tiny_test() -> "Cnn14Config":
        return Cnn14Config(mel_bins=64, base_channels=2)


class ConvBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c_out, 3, padding=1, bias=False, device=device)
        self.bn1 = FrozenBatchNorm(c_out, device=device)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, padding=1, bias=False, device=device)
        self.bn2 = FrozenBatchNorm(c_out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2)):
            x = F.relu(bn(F.conv2d(x, conv.weight.float(), padding=1), axis=1))
        return F.avg_pool2d(x, 2)


class Cnn14(nn.Module):
    """(B, T, mel_bins) log-mel -> (B, T // 64, out_dim) f32."""

    def __init__(self, cfg: Cnn14Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.bn0 = FrozenBatchNorm(cfg.mel_bins, device=device)
        c_in = 1
        for i, mult in enumerate((1, 2, 4, 8, 16, 32), start=1):
            setattr(self, f"conv_block{i}", ConvBlock(c_in, cfg.base_channels * mult, device))
            c_in = cfg.base_channels * mult

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.bn0(mel.float())[:, None]  # (B, 1, T, mel), NCHW
        for i in range(1, 7):
            x = getattr(self, f"conv_block{i}")(x)
        return x.mean(dim=3).transpose(1, 2)


def convert_cnn14_torch_state(sd: Dict[str, torch.Tensor], cfg: Cnn14Config) -> Dict[str, torch.Tensor]:
    """A PANNs / ASE Cnn14 state dict -> ``Cnn14`` ``state_dict`` names, f32."""
    if any("resnet" in k or "stem" in k for k in sd):
        raise NotImplementedError("ResNet38 CLAP towers are not supported; use Cnn14")
    return pick_state(sd, Cnn14(cfg, device="meta"))
