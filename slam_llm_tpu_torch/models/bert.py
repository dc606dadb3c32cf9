"""BERT encoder: the CLAP text tower, FENSE's two scorers and the ``hf-text`` encoder.

Counterpart of ``slam_llm_tpu/models/bert.py``: post-LN BERT, word +
position + token-type embeddings with LayerNorm, then per layer MHA ->
add & LayerNorm -> exact-GELU MLP -> add & LayerNorm. It computes in f32
whatever dtype its weights are stored in (the recipes freeze it, and the
trainer may store a frozen copy in bf16): every product reads its weight as
f32. The attention is plain torch, as the JAX package's is XLA: the key
mask adds -1e9 to masked scores, so a row whose every key is masked
attends to all of them, as in JAX.

The module's ``state_dict`` names are HF ``BertModel``'s, so
``convert_bert_torch_state`` only picks this module's tensors out of an HF
state dict (the pooler, ``position_ids`` and extra layers are skipped).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from slam_llm_tpu_torch.models.layers import dense_f32, layer_norm_f32, pick_state


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    max_positions: int = 512
    type_vocab_size: int = 2
    ln_eps: float = 1e-12

    @staticmethod
    def base_uncased() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny_test() -> "BertConfig":
        return BertConfig(vocab_size=120, d_model=32, n_layers=2, n_heads=2, ffn_dim=64, max_positions=64)


BERT_PRESETS = {"bert-base-uncased": BertConfig.base_uncased, "bert-tiny-test": BertConfig.tiny_test}


def _container(**children) -> nn.Module:
    mod = nn.Module()
    for name, child in children.items():
        setattr(mod, name, child)
    return mod


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        d, eps = cfg.d_model, cfg.ln_eps
        self.n_heads = cfg.n_heads
        self.attention = _container(
            self=_container(query=nn.Linear(d, d, device=device), key=nn.Linear(d, d, device=device),
                            value=nn.Linear(d, d, device=device)),
            output=_container(dense=nn.Linear(d, d, device=device), LayerNorm=nn.LayerNorm(d, eps, device=device)),
        )
        self.intermediate = _container(dense=nn.Linear(d, cfg.ffn_dim, device=device))
        self.output = _container(dense=nn.Linear(cfg.ffn_dim, d, device=device),
                                 LayerNorm=nn.LayerNorm(d, eps, device=device))

    def forward(self, x: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h, att = self.n_heads, self.attention
        q, k, v = (dense_f32(lin, x).reshape(b, t, h, d // h)
                   for lin in (att.self.query, att.self.key, att.self.value))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d // h)
        probs = torch.softmax(scores + neg, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, d)
        x = layer_norm_f32(att.output.LayerNorm, x + dense_f32(att.output.dense, o))
        y = F.gelu(dense_f32(self.intermediate.dense, x), approximate="none")
        return layer_norm_f32(self.output.LayerNorm, x + dense_f32(self.output.dense, y))


class BertEncoder(nn.Module):
    """(B, T) token ids + (B, T) mask (1 = valid) -> (B, T, d_model) f32;
    the CLS state is ``[:, 0]``."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.embeddings = _container(
            word_embeddings=nn.Embedding(cfg.vocab_size, d, device=device),
            position_embeddings=nn.Embedding(cfg.max_positions, d, device=device),
            token_type_embeddings=nn.Embedding(cfg.type_vocab_size, d, device=device),
            LayerNorm=nn.LayerNorm(d, cfg.ln_eps, device=device),
        )
        self.encoder = _container(layer=nn.ModuleList(BertLayer(cfg, device) for _ in range(cfg.n_layers)))

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones(b, t, dtype=torch.int32, device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros(b, t, dtype=torch.long, device=input_ids.device)
        e = self.embeddings
        x = (e.word_embeddings.weight.float()[input_ids.long()] + e.position_embeddings.weight.float()[:t][None]
             + e.token_type_embeddings.weight.float()[token_type_ids.long()])
        x = layer_norm_f32(e.LayerNorm, x)
        neg = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9).float()
        for layer in self.encoder.layer:
            x = layer(x, neg)
        return x


def convert_bert_torch_state(sd: Dict[str, torch.Tensor], cfg: BertConfig) -> Dict[str, torch.Tensor]:
    """An HF ``BertModel`` state dict (any wrapper prefix already stripped)
    -> ``BertEncoder`` ``state_dict`` names, f32."""
    return pick_state(sd, BertEncoder(cfg, device="meta"))
