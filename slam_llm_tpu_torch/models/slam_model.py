"""The fusion model: audio encoder -> projector -> embedding splice -> LLM.

Counterpart of ``slam_llm_tpu/models/slam_model.py`` with the same batch
contract (``audio_mel``/``audio_mel_mask`` for whisper, ``audio``/``audio_mask``
for the raw-waveform encoders, ``input_ids`` with -1 on audio pseudo-tokens,
``attention_mask``, ``modality_mask``, ``labels`` with -100 on ignored
positions). ``forward`` returns the loss and next-token accuracy of the
training step; a frozen encoder runs without autograd. The ported encoders
are whisper, the WavLM family (``wavlm``, ``hubert``, ``emotion2vec``), the
fbank encoders of the audio-captioning recipes (``eat``, ``beats``) and
MusicFM (``musicfm``), which read ``audio_mel`` / ``audio_mel_mask`` as
whisper does, Spatial-AST (``spatial_ast``), which reads the binaural
feature map ``audio_binaural``, and the BERT text encoder ``hf-text``, which
reads ``text_input_ids`` / ``text_input_mask``, and AV-HuBERT (``av_hubert``),
which reads ``visual`` / ``audio_feats`` / ``visual_mask``.
Without an encoder (``encoder_name: null``, DRCap) the batch's ``audio_mel``
(else ``audio``) is the encoder output, with ``audio_mel_mask`` or ones:
DRCap's one-frame CLAP latents. VALL-E X raises ``NotImplementedError``. The projector is linear, cov1d-linear or q-former.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from slam_llm_tpu_torch.models.avhubert import AVHUBERT_PRESETS, AVHubertEncoder
from slam_llm_tpu_torch.models.beats import BEATS_PRESETS, BEATsEncoder
from slam_llm_tpu_torch.models.bert import BERT_PRESETS, BertEncoder
from slam_llm_tpu_torch.models.llm import CausalLM, KVCache, LLMConfig
from slam_llm_tpu_torch.models.musicfm import MUSICFM_PRESETS, MusicFMEncoder
from slam_llm_tpu_torch.models.projector import ProjectorConfig, build_projector
from slam_llm_tpu_torch.models.spatial_ast import SPATIAL_AST_PRESETS, SpatialASTEncoder
from slam_llm_tpu_torch.models.vit import VIT_PRESETS, ViTEncoder
from slam_llm_tpu_torch.models.wavlm import WAVLM_PRESETS, WavLMEncoder
from slam_llm_tpu_torch.models.whisper import PRESETS as WHISPER_PRESETS
from slam_llm_tpu_torch.models.whisper import WhisperEncoder
from slam_llm_tpu_torch.ops.quant import check_bwd_mode

IGNORE_INDEX = -100
_TODO_ENCODERS = "ROADMAP Queue 1: vallex"
RAW_ENCODERS = ("wavlm", "hubert", "emotion2vec")  # read the raw waveform


@dataclass(frozen=True)
class SLAMConfig:
    llm: LLMConfig = field(default_factory=LLMConfig.tiny_test)
    # whisper | wavlm | hubert | emotion2vec | eat | beats | musicfm | spatial_ast | av_hubert | hf-text | None
    encoder_name: Optional[str] = "whisper"
    encoder: Any = None  # the encoder's config (WhisperEncoderConfig, WavLMConfig, MusicFMConfig, ...)
    projector: str = "linear"
    projector_cfg: ProjectorConfig = field(default_factory=ProjectorConfig)
    freeze_encoder: bool = True
    freeze_llm: bool = True


def splice_modality(
    inputs_embeds: torch.Tensor,  # (B, T, D)
    encoder_outs: torch.Tensor,  # (B, Te, D)
    modality_mask: torch.Tensor,  # (B, T) 1 where audio pseudo-tokens sit
) -> torch.Tensor:
    """Encoder frame j lands at position start + j, where start is the first
    set slot of ``modality_mask``. Pseudo-token slots past the encoder length
    become ZERO embeddings, not text embeddings (the reference's
    ``encoder_outs_pad + inputs_embeds * ~modality_mask``)."""
    t = inputs_embeds.shape[1]
    enc_t = encoder_outs.shape[1]
    mm = modality_mask.bool()
    start = mm.to(torch.int32).argmax(dim=1)  # 0 for an empty row
    rel = torch.arange(t, device=mm.device)[None, :] - start[:, None]
    valid = mm & (rel >= 0) & (rel < enc_t)
    idx = rel.clamp(0, enc_t - 1)[..., None].expand(-1, -1, encoder_outs.shape[-1])
    gathered = torch.gather(encoder_outs, 1, idx).to(inputs_embeds.dtype)
    out = torch.where(valid[..., None], gathered, inputs_embeds)
    return torch.where((mm & ~valid)[..., None], torch.zeros_like(out), out)


def causal_lm_loss_and_accuracy(
    logits: torch.Tensor,  # (B, T, V) f32
    labels: torch.Tensor,  # (B, T) with IGNORE_INDEX masking
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shifted CE + next-token accuracy over the non-ignored positions."""
    shift_logits, shift_labels = logits[:, :-1], labels[:, 1:]
    mask = (shift_labels != IGNORE_INDEX).float()
    safe = shift_labels.clamp_min(0)
    nll = torch.logsumexp(shift_logits, dim=-1) - shift_logits.gather(-1, safe[..., None])[..., 0]
    denom = mask.sum().clamp_min(1.0)
    acc = ((shift_logits.argmax(-1) == safe).float() * mask).sum() / denom
    return (nll * mask).sum() / denom, acc.detach()


class SLAMModel(nn.Module):
    def __init__(self, cfg: SLAMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        if cfg.encoder_name == "whisper":
            self.encoder = WhisperEncoder(cfg.encoder, device)
        elif cfg.encoder_name in RAW_ENCODERS:
            self.encoder = WavLMEncoder(cfg.encoder, device)
        elif cfg.encoder_name == "eat":
            self.encoder = ViTEncoder(cfg.encoder, device)
        elif cfg.encoder_name == "beats":
            self.encoder = BEATsEncoder(cfg.encoder, device)
        elif cfg.encoder_name == "musicfm":
            self.encoder = MusicFMEncoder(cfg.encoder, device)
        elif cfg.encoder_name == "spatial_ast":
            self.encoder = SpatialASTEncoder(cfg.encoder, device)
        elif cfg.encoder_name == "av_hubert":
            self.encoder = AVHubertEncoder(cfg.encoder, device)
        elif cfg.encoder_name == "hf-text":
            self.encoder = BertEncoder(cfg.encoder, device)
        elif cfg.encoder_name is None:
            self.encoder = None
        else:
            raise NotImplementedError(f"encoder {cfg.encoder_name!r} is not ported yet ({_TODO_ENCODERS})")
        self.encoder_projector = build_projector(cfg.projector, cfg.projector_cfg, device)
        self.llm = CausalLM(cfg.llm, device)

    def encode(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Projected encoder states + their validity mask. A frozen encoder
        runs under ``no_grad``: nothing upstream of the projector trains.
        Without an encoder, ``audio_mel`` (else ``audio``) is the encoder
        output, with ``audio_mel_mask`` or ones."""
        frozen = contextlib.nullcontext() if not self.cfg.freeze_encoder else torch.no_grad()
        with frozen:
            if self.encoder is None:
                enc = batch["audio_mel"] if "audio_mel" in batch else batch["audio"]
                enc_mask = batch.get("audio_mel_mask")
                if enc_mask is None:
                    enc_mask = torch.ones(enc.shape[:2], dtype=torch.int32, device=enc.device)
            elif self.cfg.encoder_name in RAW_ENCODERS:
                enc, enc_mask = self.encoder(batch["audio"], batch.get("audio_mask"))
            elif self.cfg.encoder_name == "hf-text":
                enc_mask = batch["text_input_mask"]
                enc = self.encoder(batch["text_input_ids"], enc_mask)
            elif self.cfg.encoder_name == "spatial_ast":
                enc, enc_mask = self.encoder(batch["audio_binaural"])
            elif self.cfg.encoder_name == "av_hubert":
                enc, enc_mask = self.encoder(batch.get("visual"), batch.get("audio_feats"), batch.get("visual_mask"))
            else:  # whisper, eat, beats, musicfm
                enc, enc_mask = self.encoder(batch["audio_mel"], batch.get("audio_mel_mask"))
        if self.cfg.projector == "q-former":
            # every query slot stays attendable, as in the reference: the
            # queries cross-attend the masked encoder states
            proj = self.encoder_projector(enc, enc_mask)
            return proj, torch.ones(proj.shape[:2], dtype=torch.int32, device=proj.device)
        proj = self.encoder_projector(enc)
        k = self.cfg.projector_cfg.ds_rate
        t_keep = (enc_mask.shape[1] // k) * k
        proj_mask = enc_mask[:, :t_keep].reshape(enc_mask.shape[0], -1, k).amax(-1)
        return proj, proj_mask[:, : proj.shape[1]]

    def forward_embeds(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Spliced ``inputs_embeds`` and the attention mask: the projected
        features go in whenever there is an encoder or the batch carries
        ``audio_mel`` / ``audio``."""
        inputs_embeds = self.llm.embed(batch["input_ids"].clamp_min(0))  # -1 pseudo -> 0
        if self.encoder is not None or "audio_mel" in batch or "audio" in batch:
            encoder_outs, _ = self.encode(batch)
            inputs_embeds = splice_modality(inputs_embeds, encoder_outs, batch["modality_mask"])
        return inputs_embeds, batch["attention_mask"]

    def forward(self, batch: Dict[str, torch.Tensor], return_logits: bool = False) -> Dict[str, torch.Tensor]:
        """``{"loss", "acc"}`` of the batch's shifted labels, the head fused
        into a chunked CE; ``return_logits`` takes the unfused path and adds
        the (B, T, V) f32 ``logits``."""
        inputs_embeds, attention_mask = self.forward_embeds(batch)
        if return_logits:
            logits = self.llm(inputs_embeds, attention_mask)
            loss, acc = causal_lm_loss_and_accuracy(logits, batch["labels"])
            return {"loss": loss, "acc": acc, "logits": logits}
        loss, acc = self.llm.loss_and_accuracy(inputs_embeds, attention_mask, batch["labels"])
        return {"loss": loss, "acc": acc}

    def prefill(self, batch: Dict[str, torch.Tensor], cache: KVCache):
        return self.llm.prefill(*self.forward_embeds(batch), cache)

    def decode_step(self, token_ids, cache, cache_index, attention_mask, positions):
        embeds = self.llm.embed(token_ids.clamp_min(0))
        return self.llm.decode_step(embeds, cache, cache_index, attention_mask, positions)


def build_slam_config(train_config, model_config) -> SLAMConfig:
    """Map the user-facing configs (``slam_llm_tpu.config``) to ``SLAMConfig``."""
    mc, tc = model_config, train_config
    if mc.encoder_name == "whisper":
        enc_cfg = WHISPER_PRESETS[mc.encoder_config or "whisper-tiny"]()
        encoder_dim = enc_cfg.d_model
    elif mc.encoder_name in RAW_ENCODERS:
        preset = mc.encoder_config or ("emotion2vec-base" if mc.encoder_name == "emotion2vec" else "wavlm-base")
        enc_cfg = WAVLM_PRESETS[preset]()
        encoder_dim = enc_cfg.d_model
    elif mc.encoder_name == "eat":
        enc_cfg = VIT_PRESETS[mc.encoder_config or "eat-base"]()
        encoder_dim = enc_cfg.d_model
    elif mc.encoder_name == "beats":
        enc_cfg = BEATS_PRESETS[mc.encoder_config or "beats-iter3"]()
        encoder_dim = enc_cfg.d_model
    elif mc.encoder_name == "musicfm":
        enc_cfg = MUSICFM_PRESETS[mc.encoder_config or "musicfm-msd"]()
        encoder_dim = enc_cfg.d_model
    elif mc.encoder_name == "spatial_ast":
        enc_cfg = SPATIAL_AST_PRESETS[mc.encoder_config or "spatialast-base"]()
        encoder_dim = enc_cfg.d_model
    elif mc.encoder_name == "av_hubert":
        enc_cfg = AVHUBERT_PRESETS[mc.encoder_config or "avhubert-large"]()
        encoder_dim = enc_cfg.d_model
    elif mc.encoder_name == "hf-text":
        enc_cfg = BERT_PRESETS[mc.encoder_config or "bert-base-uncased"]()
        encoder_dim = enc_cfg.d_model
    elif mc.encoder_name is None:
        enc_cfg, encoder_dim = None, mc.encoder_dim
    else:
        raise NotImplementedError(f"encoder {mc.encoder_name!r} is not ported yet ({_TODO_ENCODERS})")

    llm_presets = {
        "tinyllama-1.1b": LLMConfig.tinyllama_1_1b,
        "vicuna-7b": LLMConfig.vicuna_7b,
        "qwen2-7b": LLMConfig.qwen2_7b,
        "tiny-test": LLMConfig.tiny_test,
    }
    if mc.llm_name not in llm_presets:
        raise ValueError(f"unknown llm_name {mc.llm_name!r}; presets: {sorted(llm_presets)}")
    llm_cfg = llm_presets[mc.llm_name]()
    if tc.use_peft:
        pc = tc.peft_config
        method = getattr(pc, "peft_method", "lora")
        if method != "lora":
            raise NotImplementedError(f"peft_method {method!r} is not ported yet (only lora)")
        llm_cfg = dataclasses.replace(
            llm_cfg, peft_method="lora", lora_rank=pc.r, lora_alpha=float(pc.lora_alpha),
            lora_dropout=float(pc.lora_dropout), lora_targets=tuple(pc.target_modules),
        )
    shard = tc.shard
    if getattr(shard, "bwd_pretranspose", False):
        raise NotImplementedError("shard.bwd_pretranspose is not ported yet (ROADMAP Queue 1)")
    llm_cfg = dataclasses.replace(
        llm_cfg,
        base_quant=getattr(shard, "base_quant", "none"),
        base_quant_bwd=getattr(shard, "base_quant_bwd", "bf16"),
        ce_quant=getattr(shard, "ce_quant", "none"),
        remat=shard.remat,
        remat_policy=shard.remat_policy,
    )
    if llm_cfg.base_quant != "none":
        check_bwd_mode(llm_cfg.base_quant_bwd)
    proj_cfg = ProjectorConfig(
        encoder_dim=encoder_dim, llm_dim=llm_cfg.d_model, ds_rate=mc.encoder_projector_ds_rate,
        query_len=mc.query_len, qformer_layers=mc.qformer_layers,
        qformer_dim=getattr(mc, "qformer_dim", 768), qformer_heads=getattr(mc, "qformer_heads", 12),
    )
    return SLAMConfig(
        llm=llm_cfg, encoder_name=mc.encoder_name, encoder=enc_cfg,
        projector=mc.encoder_projector, projector_cfg=proj_cfg,
        freeze_encoder=tc.freeze_encoder, freeze_llm=tc.freeze_llm,
    )


def model_factory(train_config, model_config, device=None, **kwargs):
    """Build ``(SLAMModel, tokenizer)`` with zero-filled weights on ``device``;
    ``pipeline.common.materialize_params`` fills them."""
    from slam_llm_tpu_torch.data.tokenizer import load_tokenizer

    if model_config.llm_name.startswith("vallex"):
        raise NotImplementedError(f"llm_name {model_config.llm_name!r} is not ported yet ({_TODO_ENCODERS})")
    tokenizer = load_tokenizer(model_config.llm_path)
    cfg = build_slam_config(train_config, model_config)
    if tokenizer.vocab_size > cfg.llm.vocab_size:
        cfg = dataclasses.replace(
            cfg, llm=dataclasses.replace(cfg.llm, vocab_size=tokenizer.vocab_size)
        )
    return SLAMModel(cfg, device), tokenizer
