"""Encoder -> LLM projectors.

Counterpart of ``slam_llm_tpu/models/projector.py``, with the same shape
semantics:

* ``linear`` (``ProjectorConcat``): stack ``ds_rate`` consecutive frames
  (dropping the ``T % ds_rate`` tail), then linear -> ReLU -> linear to the
  LLM width;
* ``cov1d-linear`` (``ProjectorConv1d``): conv1d (kernel and stride
  ``ds_rate``, no padding) -> ReLU -> the same MLP;
* ``q-former`` (``ProjectorQFormer``): ``query_len`` learned queries through
  ``qformer_layers`` pre-LN blocks (self-attention, cross-attention into the
  encoder states, GELU MLP), then linear to the LLM width and LayerNorm. Its
  output is (B, query_len, llm_dim) whatever the encoder length.

The projector trains: its kernels, biases, LayerNorm scales and biases and
the queries are ``param_dtype`` (f32) masters, cast to the compute dtype at
use. The Q-Former's self-attention (no mask) goes through
``layers.mha_attention``, so on the card it runs the flash kernels (K1
forward, K4 backward); its cross-attention carries a dense padding bias and
runs the plain attention, as the reference's does. Under tensor parallelism
(``parallel.tensor_parallel.split_qformer``) a block runs ``qformer_heads /
tp`` heads of each attention a rank, fc1 and the output ``linear`` are
column-parallel, out_proj and fc2 row-parallel; ``linear``'s columns are
gathered before ``norm``, which normalizes whole rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from slam_llm_tpu_torch.models.layers import DenseGeneralLora, LayerNorm, make_padding_bias, mha_attention
from slam_llm_tpu_torch.parallel.tensor_parallel import gather_last


@dataclass(frozen=True)
class ProjectorConfig:
    encoder_dim: int = 1280
    llm_dim: int = 2048
    ds_rate: int = 5  # encoder_projector_ds_rate
    hidden_dim: int = 2048
    # q-former only:
    query_len: int = 64
    qformer_layers: int = 8
    qformer_dim: int = 768
    qformer_heads: int = 12
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32


def post_projector_length(in_len: int, projector: str, cfg: ProjectorConfig) -> int:
    """Output length for an encoder length."""
    if projector == "q-former":
        return cfg.query_len
    if projector == "cov1d-linear":
        return (in_len - cfg.ds_rate) // cfg.ds_rate + 1
    return in_len // cfg.ds_rate  # linear: truncate then stack


def _dense(cfg: ProjectorConfig, fin: int, fout: int, device) -> DenseGeneralLora:
    return DenseGeneralLora(fin, fout, use_bias=True, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                            frozen_base=False, device=device)


class ProjectorConcat(nn.Module):
    """(B, T, E) -> (B, T // k, llm_dim)."""

    def __init__(self, cfg: ProjectorConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.linear1 = _dense(cfg, cfg.encoder_dim * cfg.ds_rate, cfg.hidden_dim, device)
        self.linear2 = _dense(cfg, cfg.hidden_dim, cfg.llm_dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, e = x.shape
        k = self.cfg.ds_rate
        t_keep = (t // k) * k
        x = x[:, :t_keep].reshape(b, t_keep // k, e * k)
        return self.linear2(F.relu(self.linear1(x)))


class ProjectorConv1d(nn.Module):
    """(B, T, E) -> (B, (T - k) // k + 1, llm_dim)."""

    def __init__(self, cfg: ProjectorConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e, k = cfg.encoder_dim, cfg.ds_rate
        # (out, in, k), an f32 master
        self.conv1d = nn.Conv1d(e, e, k, stride=k, dtype=cfg.param_dtype, device=device)
        self.linear1 = _dense(cfg, e, cfg.hidden_dim, device)
        self.linear2 = _dense(cfg, cfg.hidden_dim, cfg.llm_dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, dt = self.cfg, self.cfg.dtype
        h = F.conv1d(x.to(dt).transpose(1, 2), self.conv1d.weight.to(dt), self.conv1d.bias.to(dt), c.ds_rate)
        h = F.relu(h.transpose(1, 2))
        return self.linear2(F.relu(self.linear1(h)))


class QFormerBlock(nn.Module):
    """Pre-LN: q + self-attention, + cross-attention into the encoder, + MLP."""

    def __init__(self, cfg: ProjectorConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.qformer_dim
        for prefix, kv_in in (("self", d), ("cross", cfg.encoder_dim)):
            setattr(self, f"{prefix}_q_proj", _dense(cfg, d, d, device))
            setattr(self, f"{prefix}_k_proj", _dense(cfg, kv_in, d, device))
            setattr(self, f"{prefix}_v_proj", _dense(cfg, kv_in, d, device))
            setattr(self, f"{prefix}_out_proj", _dense(cfg, d, d, device))
        self.self_ln = LayerNorm(d, dtype=cfg.dtype, device=device)
        self.cross_ln = LayerNorm(d, dtype=cfg.dtype, device=device)
        self.mlp_ln = LayerNorm(d, dtype=cfg.dtype, device=device)
        self.fc1 = _dense(cfg, d, 4 * d, device)
        self.fc2 = _dense(cfg, 4 * d, d, device)
        self.n_heads = cfg.qformer_heads  # this rank's heads (qformer_heads / tp once split)

    def _attend(self, prefix: str, xq: torch.Tensor, xkv: torch.Tensor, bias: Optional[torch.Tensor]):
        c = self.cfg
        h, hd = self.n_heads, c.qformer_dim // c.qformer_heads
        b = xq.shape[0]
        q = getattr(self, f"{prefix}_q_proj")(xq).reshape(b, xq.shape[1], h, hd)
        k = getattr(self, f"{prefix}_k_proj")(xkv).reshape(b, xkv.shape[1], h, hd)
        v = getattr(self, f"{prefix}_v_proj")(xkv).reshape(b, xkv.shape[1], h, hd)
        out = mha_attention(q, k, v, bias=bias).reshape(b, xq.shape[1], h * hd)
        return getattr(self, f"{prefix}_out_proj")(out)

    def forward(self, q: torch.Tensor, enc: torch.Tensor, enc_bias: Optional[torch.Tensor]) -> torch.Tensor:
        hq = self.self_ln(q)
        q = q + self._attend("self", hq, hq, None)
        q = q + self._attend("cross", self.cross_ln(q), enc, enc_bias)
        h = F.gelu(self.fc1(self.mlp_ln(q)), approximate="none")
        return q + self.fc2(h)


class ProjectorQFormer(nn.Module):
    """(B, T, E) + (B, T) mask -> (B, query_len, llm_dim)."""

    def __init__(self, cfg: ProjectorConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.query = nn.Parameter(torch.zeros(cfg.query_len, cfg.qformer_dim, dtype=cfg.param_dtype, device=device),
                                  requires_grad=False)
        for i in range(cfg.qformer_layers):
            self.add_module(f"block_{i}", QFormerBlock(cfg, device))
        self.linear = _dense(cfg, cfg.qformer_dim, cfg.llm_dim, device)
        self.norm = LayerNorm(cfg.llm_dim, dtype=cfg.dtype, device=device)
        self.tp = None  # parallel.tensor_parallel.TP once split over tp

    def forward(self, x: torch.Tensor, enc_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        q = self.query.to(c.dtype)[None].expand(x.shape[0], -1, -1)
        enc_bias = None if enc_mask is None else make_padding_bias(enc_mask, c.query_len)
        x = x.to(c.dtype)
        for i in range(c.qformer_layers):
            q = getattr(self, f"block_{i}")(q, x, enc_bias)
        out = self.linear(q)
        return self.norm(out if self.tp is None else gather_last(out, self.tp))


def build_projector(name: str, cfg: ProjectorConfig, device=None) -> nn.Module:
    if name == "linear":
        return ProjectorConcat(cfg, device)
    if name == "cov1d-linear":
        return ProjectorConv1d(cfg, device)
    if name == "q-former":
        return ProjectorQFormer(cfg, device)
    raise ValueError(f"unknown projector: {name}")
