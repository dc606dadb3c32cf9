"""CLAP / ASE: the contrastive language-audio model of DRCap and CLAP-Refine.

Counterpart of ``slam_llm_tpu/models/clap.py`` (f32):

* audio tower: HTSAT (``models.htsat``), pooled as the mean of its
  ``fine_grained_embedding``; or Cnn14 (``models.cnn14``), mean over time;
  or the EAT ViT (``models.vit``), the masked mean of its tokens;
* text tower: BERT (``models.bert``), the CLS state;
* projections: Linear -> ReLU -> Linear into ``embed_dim``, L2-normalized;
* ``forward``: the symmetric InfoNCE over in-batch pairs, the learned
  temperature clamped into [1e-3, 0.5].

``state_dict`` names follow the reference's ASE checkpoint with its two
wrappers dropped (``audio_enc.*``, ``text_enc.*``, ``audio_proj.{0,2}``,
``text_proj.{0,2}``, ``temp``); ``convert_ase_torch_state`` maps a full
ASE checkpoint onto them and ``load_clap`` reads one from a torch file.
``embed_texts`` runs the text tower over a ``utils.fense.WordPieceTokenizer``
batch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from slam_llm_tpu_torch.models.bert import BertConfig, BertEncoder, convert_bert_torch_state
from slam_llm_tpu_torch.models.cnn14 import Cnn14, Cnn14Config, convert_cnn14_torch_state
from slam_llm_tpu_torch.models.htsat import HTSAT, HTSATConfig, convert_htsat_torch_state
from slam_llm_tpu_torch.models.layers import dense_f32
from slam_llm_tpu_torch.models.vit import ViTEncoder, ViTEncoderConfig


@dataclass(frozen=True)
class CLAPConfig:
    embed_dim: int = 1024  # the reference's embed_size
    audio_tower: str = "htsat"  # htsat | cnn14 | vit
    cnn14: Cnn14Config = field(default_factory=Cnn14Config)
    htsat: HTSATConfig = field(default_factory=HTSATConfig)
    bert: BertConfig = field(default_factory=BertConfig.base_uncased)
    vit: Optional[ViTEncoderConfig] = None
    temp_init: float = 0.07

    @staticmethod
    def tiny_test() -> "CLAPConfig":
        return CLAPConfig(embed_dim=16, htsat=HTSATConfig.tiny_test(), bert=BertConfig.tiny_test())

    @property
    def audio_dim(self) -> int:
        if self.audio_tower == "htsat":
            return self.htsat.num_features
        if self.audio_tower == "cnn14":
            return self.cnn14.out_dim
        return self.vit.d_model


def _proj(fin: int, fout: int, device) -> nn.Sequential:
    return nn.Sequential(nn.Linear(fin, fout, device=device), nn.ReLU(), nn.Linear(fout, fout, device=device))


def _apply_proj(proj: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    z = dense_f32(proj[2], F.relu(dense_f32(proj[0], x.float())))
    return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)


class CLAP(nn.Module):
    def __init__(self, cfg: CLAPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        if cfg.audio_tower == "htsat":
            self.audio_enc = HTSAT(cfg.htsat, device)
        elif cfg.audio_tower == "cnn14":
            self.audio_enc = Cnn14(cfg.cnn14, device)
        elif cfg.audio_tower == "vit":
            self.audio_enc = ViTEncoder(cfg.vit, device)
        else:
            raise ValueError(f"unknown CLAP audio tower {cfg.audio_tower!r}")
        self.text_enc = BertEncoder(cfg.bert, device)
        self.audio_proj = _proj(cfg.audio_dim, cfg.embed_dim, device)
        self.text_proj = _proj(cfg.bert.d_model, cfg.embed_dim, device)
        self.temp = nn.Parameter(torch.tensor(cfg.temp_init, device=device))

    def encode_audio(self, mel: torch.Tensor, mel_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mel (B, T, n_mels) -> L2-normalized (B, embed_dim)."""
        if self.cfg.audio_tower == "htsat":
            pooled = self.audio_enc(mel.float())["fine_grained_embedding"].mean(dim=1)
        elif self.cfg.audio_tower == "cnn14":
            pooled = self.audio_enc(mel).mean(dim=1)
        else:
            feats, mask = self.audio_enc(mel, mel_mask)
            m = mask[..., None].float()
            pooled = (feats.float() * m).sum(1) / m.sum(1).clamp_min(1.0)
        return _apply_proj(self.audio_proj, pooled)

    def encode_text(self, text_ids: torch.Tensor, text_mask: torch.Tensor) -> torch.Tensor:
        """CLS state of BERT -> L2-normalized (B, embed_dim)."""
        return _apply_proj(self.text_proj, self.text_enc(text_ids.clamp_min(0), text_mask)[:, 0])

    def similarity(self, audio_z: torch.Tensor, text_z: torch.Tensor) -> torch.Tensor:
        return audio_z @ text_z.T

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The symmetric InfoNCE of ``audio_mel`` against ``text_ids`` /
        ``text_mask``: ``{"loss", "acc", "logits"}``."""
        za = self.encode_audio(batch["audio_mel"], batch.get("audio_mel_mask"))
        zt = self.encode_text(batch["text_ids"], batch["text_mask"])
        logits = za @ zt.T / self.temp.float().clamp(1e-3, 0.5)
        labels = torch.arange(za.shape[0], device=za.device)
        loss = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))
        acc = (logits.argmax(dim=1) == labels).float().mean()
        return {"loss": loss, "acc": acc, "logits": logits}


def convert_ase_torch_state(sd: Dict[str, torch.Tensor], cfg: CLAPConfig) -> Dict[str, torch.Tensor]:
    """A reference ASE state dict (``audio_encoder.audio_enc.*``, optionally
    ``sed_model.``-prefixed; ``text_encoder.text_enc.*``; the ``audio_proj`` /
    ``text_proj`` Sequentials; ``temp``) -> ``CLAP`` ``state_dict`` names, f32."""

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    audio = sub("audio_encoder.audio_enc.")
    if cfg.audio_tower == "cnn14":
        audio = convert_cnn14_torch_state(audio, cfg.cnn14)
    else:
        audio = convert_htsat_torch_state(audio, cfg.htsat)
    out = {f"audio_enc.{k}": v for k, v in audio.items()}
    out.update({f"text_enc.{k}": v for k, v in convert_bert_torch_state(sub("text_encoder.text_enc."), cfg.bert).items()})
    for name in ("audio_proj", "text_proj"):
        for i in (0, 2):  # Linear, ReLU, Linear
            for leaf in ("weight", "bias"):
                out[f"{name}.{i}.{leaf}"] = torch.as_tensor(sd[f"{name}.{i}.{leaf}"]).float()
    out["temp"] = torch.as_tensor(sd.get("temp", cfg.temp_init)).float().reshape(())
    return out


def load_clap(path: str, cfg: CLAPConfig = CLAPConfig(), device="cuda") -> CLAP:
    """An ASE checkpoint file (``{"model": sd}``, ``{"state_dict": sd}`` or
    the state dict; tensors only) -> an eval-mode ``CLAP`` on ``device``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("model", sd.get("state_dict", sd))
    model = CLAP(cfg, device=device)
    model.load_state_dict(convert_ase_torch_state(sd, cfg))
    return model.eval()


@torch.inference_mode()
def embed_texts(model: CLAP, tokenizer, texts: Sequence[str], max_len: int = 64) -> np.ndarray:
    """(N, embed_dim) f32 text embeddings of ``texts``, tokenized by a
    ``utils.fense.WordPieceTokenizer`` and padded to the longest."""
    ids, mask = tokenizer.batch(list(texts), max_len)
    dev = model.temp.device
    z = model.encode_text(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev))
    return z.cpu().numpy()
