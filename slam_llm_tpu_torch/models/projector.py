"""Encoder -> LLM projector (linear frame-stack form).

Counterpart of ``slam_llm_tpu/models/projector.py``'s ``ProjectorConcat``:
stack ``ds_rate`` consecutive frames (dropping the ``T % ds_rate`` tail),
then linear -> ReLU -> linear to the LLM width. The projector trains: its
kernels and biases are ``param_dtype`` (f32) masters, cast to the compute
dtype at use. The conv1d and q-former projectors are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from slam_llm_tpu_torch.models.layers import DenseGeneralLora


@dataclass(frozen=True)
class ProjectorConfig:
    encoder_dim: int = 1280
    llm_dim: int = 2048
    ds_rate: int = 5  # encoder_projector_ds_rate
    hidden_dim: int = 2048
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32


class ProjectorConcat(nn.Module):
    """(B, T, E) -> (B, T // k, llm_dim)."""

    def __init__(self, cfg: ProjectorConfig, device=None):
        super().__init__()
        self.cfg = cfg

        def dense(fin, fout):
            return DenseGeneralLora(fin, fout, use_bias=True, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                                    frozen_base=False, device=device)

        self.linear1 = dense(cfg.encoder_dim * cfg.ds_rate, cfg.hidden_dim)
        self.linear2 = dense(cfg.hidden_dim, cfg.llm_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, e = x.shape
        k = self.cfg.ds_rate
        t_keep = (t // k) * k
        x = x[:, :t_keep].reshape(b, t_keep // k, e * k)
        return self.linear2(F.relu(self.linear1(x)))


def build_projector(name: str, cfg: ProjectorConfig, device=None) -> nn.Module:
    if name == "linear":
        return ProjectorConcat(cfg, device)
    raise NotImplementedError(
        f"projector {name!r} is not ported yet (ROADMAP: port the conv1d and q-former projectors)"
    )
