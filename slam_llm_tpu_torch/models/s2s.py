"""S2S (SLAM-Omni): speech-to-speech dialogue with parallel text + audio heads.

Counterpart of ``slam_llm_tpu/models/s2s.py``:

* the LLM's vocabulary is ``padded_text + code_layer * padded_audio``
  (``VocabConfig``); audio token ids of codebook layer i live at offset
  ``padded_text + i * padded_audio`` (``layershift``);
* the input is ``code_layer + 1`` parallel token streams; the embedding is
  their MEAN, with the encoder's features spliced into each audio stream's
  placeholder span;
* one trunk forward; the logits split into a text head and ``code_layer``
  audio heads, through the linear group-decode adapter (one audio slot ->
  code_layer vocabularies) when ``group_decode``; the embedding covers the
  whole vocabulary while the head stops at text + one slot (``head_size``);
* loss = mean of the text CE and the per-layer audio CEs, each a logsumexp
  and a gather over the f32 logits (the JAX package materializes them too);
* with ``tts_adapter``, extra decoder blocks over the LLM's hidden states
  feed a dedicated audio head (training and decoding);
* ``S2SGenerator`` samples a text token and ``code_layer`` audio tokens a
  step, with separate repetition penalties and separate text / audio EOS,
  as a Python loop over static-shape tensors on the device (the JAX
  package's ``lax.while_loop``); ``stream_generate`` yields chunks. A model
  sharded over fsdp decodes in lockstep over the data ranks (``mesh``):
  every stop test is global, a rank whose rows ended steps on with them
  frozen.

Tensor parallelism (``tp``, set by ``parallel.tensor_parallel.split_for_tp``:
the LLM, the group-decode adapter, the TTS adapter's blocks and head split
over the vocabulary / heads, as the JAX package's ``vocab -> tp`` rule
shards both heads): the training loss holds no whole (B, T, vocabulary)
logits. The text CE runs over the window [0, padded_text) of the rank's
head rows (``ops.fused_ce.windowed_linear_ce``, its logits rounded to the
compute dtype as the head's output is); the head's audio slot comes from
the rank(s) holding its rows (a masked local product, then an exact
all-reduce: one nonzero contributor a column); each codebook's CE reads its
window of the rank's adapter or TTS-head shard
(``ops.fused_ce.windowed_logits_ce``). Without group decode or the TTS
adapter, every CE is a window of the head. Decoding gathers what the
sampler reads, so every tp rank samples the same tokens; ``return_logits``
gathers the head's logits on request.

``model_factory`` is the port's copy of the recipe factory
``examples/s2s/model/slam_model_s2s.py:model_factory`` (which imports the
JAX package): ``registry.resolve_factory`` maps that spec here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from slam_llm_tpu_torch.inference.generate import _apply_repetition_penalty, _last_valid_index, _sync, decode_mode
from slam_llm_tpu_torch.models.layers import DenseGeneralLora, RMSNorm
from slam_llm_tpu_torch.models.llm import (
    CausalLM,
    DecoderLayer,
    KVCache,
    LLMConfig,
    _positions_from_mask,
    decode_layers,
    init_kv_cache,
    prefill_layers,
)
from slam_llm_tpu_torch.models.projector import ProjectorConfig, build_projector
from slam_llm_tpu_torch.models.slam_model import IGNORE_INDEX, splice_modality
from slam_llm_tpu_torch.models.whisper import WhisperEncoder
from slam_llm_tpu_torch.ops.fused_ce import windowed_linear_ce, windowed_logits_ce
from slam_llm_tpu_torch.parallel.sharding import all_running, sharded_decode, token_count
from slam_llm_tpu_torch.parallel.tensor_parallel import copy_to_tp, gather_last, reduce_from_tp


@dataclass(frozen=True)
class VocabConfig:
    """The reference's s2s_config.py VocabConfig, derived fields included."""

    text_vocabsize: int = 151936
    text_specialtokens: int = 64
    audio_vocabsize: int = 4096
    audio_specialtokens: int = 64
    code_layer: int = 7

    @property
    def padded_text_vocabsize(self) -> int:
        return self.text_vocabsize + self.text_specialtokens

    @property
    def padded_audio_vocabsize(self) -> int:
        return self.audio_vocabsize + self.audio_specialtokens

    @property
    def total_audio_vocabsize(self) -> int:
        return self.padded_audio_vocabsize * self.code_layer

    @property
    def total_vocabsize(self) -> int:
        return self.padded_text_vocabsize + self.total_audio_vocabsize

    # special text tokens
    @property
    def eot(self):
        return self.text_vocabsize

    @property
    def pad_t(self):
        return self.text_vocabsize + 1

    @property
    def input_t(self):
        return self.text_vocabsize + 2

    @property
    def answer_t(self):
        return self.text_vocabsize + 3

    @property
    def asr(self):
        return self.text_vocabsize + 4

    # special audio tokens (before the layer shift)
    @property
    def eoa(self):
        return self.audio_vocabsize

    @property
    def pad_a(self):
        return self.audio_vocabsize + 1

    @property
    def input_a(self):
        return self.audio_vocabsize + 2

    @property
    def answer_a(self):
        return self.audio_vocabsize + 3

    @property
    def split(self):
        return self.audio_vocabsize + 4

    def layershift(self, audio_token, layer: int):
        """A codebook token -> its id in the whole vocabulary for ``layer``."""
        return audio_token + self.padded_text_vocabsize + layer * self.padded_audio_vocabsize

    @staticmethod
    def tiny_test() -> "VocabConfig":
        return VocabConfig(text_vocabsize=64, text_specialtokens=8, audio_vocabsize=32, audio_specialtokens=8,
                           code_layer=3)


@dataclass(frozen=True)
class S2SConfig:
    llm: LLMConfig = field(default_factory=LLMConfig.tiny_test)
    vocab: VocabConfig = field(default_factory=VocabConfig)
    encoder_name: Optional[str] = "whisper"
    encoder: Any = None
    projector: str = "linear"
    projector_cfg: ProjectorConfig = field(default_factory=ProjectorConfig)
    group_decode: bool = False  # one audio slot -> code_layer vocabularies
    freeze_encoder: bool = True
    freeze_llm: bool = False
    task_type: str = "s2s"  # s2s | asr | tts
    # the TTS adapter (the reference's tts_adapter_utils.py:15-28): decoder
    # blocks at the LLM's width over its hidden states, a norm and an audio
    # head; wired into training and decoding, as in the JAX package
    tts_adapter: bool = False
    tts_adapter_layers: int = 6
    # the partial-embedding tricks (the reference's trick_utils.py:7-35):
    # train_embed_only -> only the lm_head trains; train_audio_embed_only ->
    # the same, its updates masked to the audio vocabulary's columns;
    # train_embed -> the lm_head trains besides the usual policy
    train_embed_only: bool = False
    train_audio_embed_only: bool = False
    train_embed: bool = False


class GroupDecodeAdapter(nn.Module):
    """A linear from the head's one audio slot to code_layer vocabularies
    (the reference's projector_utils.py:6-16)."""

    def __init__(self, audio_slot: int, code_layer: int, vocab_per_layer: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.linear = DenseGeneralLora(audio_slot, code_layer * vocab_per_layer, use_bias=True, dtype=dtype,
                                       device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x)


class S2SModel(nn.Module):
    def __init__(self, cfg: S2SConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        if c.encoder_name == "whisper":
            self.encoder = WhisperEncoder(c.encoder, device)
        elif c.encoder_name is None:
            self.encoder = None
        else:
            raise ValueError(f"s2s encoder {c.encoder_name} not supported yet")
        self.encoder_projector = build_projector(c.projector, c.projector_cfg, device)
        v = c.vocab
        # the embedding covers the whole (layershifted) vocabulary; with group
        # decode the head stops at text + one audio slot
        head_vocab = v.padded_text_vocabsize + v.padded_audio_vocabsize if c.group_decode else v.total_vocabsize
        llm_cfg = dataclasses.replace(c.llm, vocab_size=v.total_vocabsize,
                                      head_size=head_vocab if head_vocab < v.total_vocabsize else None)
        self.llm = CausalLM(llm_cfg, device)
        self.group_decode_adapter = (
            GroupDecodeAdapter(v.padded_audio_vocabsize, v.code_layer, v.padded_audio_vocabsize, c.llm.dtype, device)
            if c.group_decode else None)
        self.adapter_cfg = None
        if c.tts_adapter:
            # plain transformer blocks (the reference's litgpt GPT): no PEFT
            self.adapter_cfg = dataclasses.replace(llm_cfg, n_layers=c.tts_adapter_layers, lora_rank=0, remat=False,
                                                   peft_method="none")
            for i in range(c.tts_adapter_layers):
                setattr(self, f"tts_adapter_{i}", DecoderLayer(self.adapter_cfg, device))
            self.tts_adapter_ln = RMSNorm(llm_cfg.d_model, dtype=c.llm.dtype, device=device)
            self.tts_adapter_head = DenseGeneralLora(llm_cfg.d_model, v.total_audio_vocabsize, dtype=c.llm.dtype,
                                                     device=device)
        self.tp = None  # parallel.tensor_parallel.TP once the heads are split over tp

    @property
    def tts_adapter_blocks(self) -> List[DecoderLayer]:
        return [getattr(self, f"tts_adapter_{i}") for i in range(self.cfg.tts_adapter_layers)] \
            if self.cfg.tts_adapter else []

    @property
    def adapter_cache_cfg(self) -> LLMConfig:
        """The config the TTS adapter's KV cache is laid out by: this rank's
        heads under tp."""
        blocks = self.tts_adapter_blocks
        return blocks[0].attn.cfg if blocks else self.adapter_cfg

    def _whole(self, local: torch.Tensor) -> torch.Tensor:
        """A column-parallel head's output gathered whole (itself without tp)."""
        return local if self.tp is None else gather_last(local, self.tp)

    # ---- the embedding of code_layer + 1 parallel streams ----------------

    def embed_streams(self, input_ids: torch.Tensor, encoder_outs: Optional[torch.Tensor],
                      modality_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """input_ids (B, L+1, T) -> the streams' mean embedding (B, T, D),
        the encoder's features spliced into each audio stream's span."""
        L = self.cfg.vocab.code_layer
        embeds = self.llm.embed(input_ids.clamp_min(0))  # (B, L+1, T, D)
        if encoder_outs is not None and modality_mask is not None:
            b, _, t, d = embeds.shape
            audio = splice_modality(embeds[:, :L].reshape(b * L, t, d),
                                    encoder_outs.repeat_interleave(L, dim=0),
                                    modality_mask.repeat_interleave(L, dim=0)).reshape(b, L, t, d)
            embeds = torch.cat([audio, embeds[:, L:]], dim=1)
        return embeds.mean(dim=1)

    def forward_embeds(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        encoder_outs = None
        if batch.get("audio_mel") is not None:
            if self.encoder is None:
                encoder_outs, enc_mask = batch["audio_mel"], batch.get("audio_mel_mask")
            else:
                frozen = torch.no_grad() if self.cfg.freeze_encoder else contextlib.nullcontext()
                with frozen:
                    encoder_outs, enc_mask = self.encoder(batch["audio_mel"], batch.get("audio_mel_mask"))
            if self.cfg.projector == "q-former":
                encoder_outs = self.encoder_projector(encoder_outs, enc_mask)
            else:
                encoder_outs = self.encoder_projector(encoder_outs)
        return self.embed_streams(batch["input_ids"], encoder_outs, batch.get("modality_mask")), \
            batch["attention_mask"]

    def _audio_split(self, flat: torch.Tensor) -> torch.Tensor:
        """(..., L * Va) -> (L, ..., Va)."""
        va = self.cfg.vocab.padded_audio_vocabsize
        return torch.stack([flat[..., i * va: (i + 1) * va] for i in range(self.cfg.vocab.code_layer)])

    def split_logits(self, logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The trunk's logits -> (text logits, audio logits (L, ..., Va))."""
        v = self.cfg.vocab
        xt, rest = logits[..., : v.padded_text_vocabsize], logits[..., v.padded_text_vocabsize:]
        if self.group_decode_adapter is not None:
            rest = self._whole(self.group_decode_adapter(rest[..., : v.padded_audio_vocabsize].to(
                self.cfg.llm.dtype))).float()
        return xt, self._audio_split(rest)

    def _adapter_audio_logits(self, ha: torch.Tensor) -> torch.Tensor:
        return self._audio_split(self._whole(self.tts_adapter_head(self.tts_adapter_ln(ha))).float())

    def forward(self, batch: Dict[str, torch.Tensor], return_logits: bool = False) -> Dict[str, torch.Tensor]:
        """The parallel loss: ``loss`` (the mean of the text and the L audio
        CEs; the text CE alone for ``task_type: asr``), ``acc`` (text),
        ``text_loss``, ``audio_loss`` / ``audio_acc`` (L,); ``logits`` (B, T,
        head) f32 with ``return_logits``."""
        c, v = self.cfg, self.cfg.vocab
        if self.tp is not None:
            return self._forward_tp(batch, return_logits)
        embeds, attention_mask = self.forward_embeds(batch)
        if c.tts_adapter:
            h = self.llm.trunk(embeds, attention_mask)
            logits = self.llm._head(h)
            xt = logits[..., : v.padded_text_vocabsize]
            pos = _positions_from_mask(attention_mask)
            ha = h
            for blk in self.tts_adapter_blocks:
                ha, _ = blk(ha, pos, kv_mask=attention_mask)
            xa = self._adapter_audio_logits(ha)
        else:
            logits = self.llm(embeds, attention_mask)
            xt, xa = self.split_logits(logits)
        labels = batch["labels"]  # (B, L+1, T)

        def ce(lg, lb):
            # logsumexp + gather, not log_softmax: no (B, T, V) log-prob tensor
            mask = (lb[:, 1:] != IGNORE_INDEX).float()
            safe = lb[:, 1:].clamp_min(0)
            lg = lg[:, :-1].float()
            nll = torch.logsumexp(lg, dim=-1) - lg.gather(-1, safe[..., None])[..., 0]
            denom = token_count(mask)
            acc = ((lg.argmax(-1) == safe).float() * mask).sum() / denom
            return (nll * mask).sum() / denom, acc.detach()

        text_loss, text_acc = ce(xt, labels[:, v.code_layer])
        audio = [ce(xa[i], labels[:, i]) for i in range(v.code_layer)]
        return self._losses(text_loss, text_acc, torch.stack([a[0] for a in audio]),
                            torch.stack([a[1] for a in audio]), logits if return_logits else None)

    def _losses(self, text_loss, text_acc, audio_losses, audio_accs, logits) -> Dict[str, torch.Tensor]:
        c, L = self.cfg, self.cfg.vocab.code_layer
        loss = text_loss if c.task_type == "asr" else (text_loss + audio_losses.sum()) / (L + 1)
        out = {"loss": loss, "acc": text_acc, "text_loss": text_loss.detach(), "audio_loss": audio_losses.detach(),
               "audio_acc": audio_accs}
        if logits is not None:
            out["logits"] = logits
        return out

    def _audio_slot(self, h: torch.Tensor) -> torch.Tensor:
        """Under tp: the head's one audio slot, its logits' columns
        [padded_text, padded_text + padded_audio) (B, T, Va) in the compute
        dtype, whole on every rank: each rank forms the slot columns its head
        rows hold (maybe none), the rest zeros, and the all-reduce adds one
        nonzero contributor a column (exact)."""
        v, llm, tp = self.cfg.vocab, self.llm, self.tp
        w, first = llm.head_weight(), llm.head_first_row()
        lo, hi = v.padded_text_vocabsize, v.padded_text_vocabsize + v.padded_audio_vocabsize
        a = min(max(lo, first), hi)
        e = max(a, min(hi, first + w.shape[0]))
        dt = self.cfg.llm.dtype
        part = torch.nn.functional.linear(copy_to_tp(h.to(dt), tp), w[a - first:e - first].to(dt))
        return reduce_from_tp(torch.nn.functional.pad(part, (a - lo, hi - e)), tp)

    def _forward_tp(self, batch: Dict[str, torch.Tensor], return_logits: bool) -> Dict[str, torch.Tensor]:
        """``forward`` on this rank's shards: every CE over a column window
        of the rank's head or adapter logits, one chunk of T at a time."""
        c, v, llm, tp = self.cfg, self.cfg.vocab, self.llm, self.tp
        L, pt, va = v.code_layer, v.padded_text_vocabsize, v.padded_audio_vocabsize
        embeds, attention_mask = self.forward_embeds(batch)
        h = llm.trunk(embeds, attention_mask)
        lb = batch["labels"][..., 1:]  # (B, L+1, T-1): the shifted labels of every stream
        kernel = llm.head_weight()
        head_ce = dict(chunk=c.llm.ce_chunk, kernel_needs_grad=kernel.requires_grad, compute_dtype=c.llm.dtype,
                       ignore_index=IGNORE_INDEX, tp=tp)
        codebooks = [(i * va, (i + 1) * va) for i in range(L)]
        if self.group_decode_adapter is None and not c.tts_adapter:  # every CE a window of the head
            losses, accs = windowed_linear_ce(h[:, :-1], kernel, [lb[:, L], *lb[:, :L].unbind(1)],
                                              [(0, pt), *((pt + lo, pt + hi) for lo, hi in codebooks)], **head_ce)
            text_loss, text_acc, audio_losses, audio_accs = losses[0], accs[0], losses[1:], accs[1:]
        else:
            losses, accs = windowed_linear_ce(h[:, :-1], kernel, [lb[:, L]], [(0, pt)], **head_ce)
            text_loss, text_acc = losses[0], accs[0]
            if c.tts_adapter:
                ha, pos = h, _positions_from_mask(attention_mask)
                for blk in self.tts_adapter_blocks:
                    ha, _ = blk(ha, pos, kv_mask=attention_mask)
                local = self.tts_adapter_head(self.tts_adapter_ln(ha))
            else:
                local = self.group_decode_adapter(self._audio_slot(h))
            audio_losses, audio_accs = windowed_logits_ce(local[:, :-1], lb[:, :L].unbind(1), codebooks,
                                                          chunk=c.llm.ce_chunk, ignore_index=IGNORE_INDEX, tp=tp)
        return self._losses(text_loss, text_acc, audio_losses, audio_accs, llm._head(h) if return_logits else None)

    # ---- decoding ----------------------------------------------------------

    def prefill(self, batch: Dict[str, torch.Tensor], cache: KVCache):
        return self.llm.prefill(*self.forward_embeds(batch), cache)

    def decode_step(self, stream_tokens, cache, cache_index, attention_mask, positions):
        """stream_tokens (B, L+1), ALREADY layershifted -> the next logits."""
        embeds = self.llm.embed(stream_tokens.clamp_min(0)).mean(dim=1)
        return self.llm.decode_step(embeds[:, None, :], cache, cache_index, attention_mask, positions)

    def prefill_tts(self, batch, cache: KVCache, adapter_cache: KVCache):
        """Prefill the trunk's and the adapter's caches; per position (text
        logits (B, T, Vt), audio logits (L, B, T, Va)) and the caches. The
        audio logits come from the adapter's head, which training trains."""
        v = self.cfg.vocab
        embeds, attention_mask = self.forward_embeds(batch)
        h, cache = self.llm.prefill_hidden(embeds, attention_mask, cache)
        xt = self.llm._head(h)[..., : v.padded_text_vocabsize]
        ha = prefill_layers(self.tts_adapter_blocks, h, attention_mask, _positions_from_mask(attention_mask),
                            adapter_cache)
        return xt, self._adapter_audio_logits(ha), cache, adapter_cache

    def decode_step_tts(self, stream_tokens, cache: KVCache, adapter_cache: KVCache, cache_index, attention_mask,
                        positions):
        """One step through the trunk and the adapter: (text logits (B, 1,
        Vt), audio logits (L, B, 1, Va), the caches)."""
        v = self.cfg.vocab
        embeds = self.llm.embed(stream_tokens.clamp_min(0)).mean(dim=1)
        h, cache = self.llm.decode_step_hidden(embeds[:, None, :], cache, cache_index, attention_mask, positions)
        xt = self.llm._head(h)[..., : v.padded_text_vocabsize]
        ha = decode_layers(self.tts_adapter_blocks, h, adapter_cache, cache_index, attention_mask, positions)
        return xt, self._adapter_audio_logits(ha), cache, adapter_cache


# ---------------------------------------------------------------------------
# parallel generation
# ---------------------------------------------------------------------------

_BATCH_KEYS = ("input_ids", "attention_mask", "modality_mask", "audio_mel", "audio_mel_mask")


class S2SGenerator:
    """Parallel text + audio decoding, greedy or sampled (top-k).

    ``stats`` accumulates over calls: ``prefill_s`` and ``decode_s`` (host
    clock around device-synchronised work), ``decode_steps`` and
    ``useful_steps`` (the steps this rank's rows needed). ``mesh``: the
    ``(dp, fsdp, tp)`` mesh of a model sharded over fsdp, whose data ranks
    step in lockstep."""

    def __init__(self, model: S2SModel, max_new_tokens: int = 360, do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0, text_repetition_penalty: float = 1.0,
                 audio_repetition_penalty: float = 1.0, num_latency_tokens: int = 0,
                 decode_text_only: bool = False, mesh=None):
        self.model = model
        self.mesh = mesh
        self.max_new_tokens = max_new_tokens
        self.do_sample, self.temperature, self.top_k = do_sample, temperature, top_k
        self.text_rp, self.audio_rp = text_repetition_penalty, audio_repetition_penalty
        self.num_latency_tokens = num_latency_tokens
        self.decode_text_only = decode_text_only
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0, "decode_steps": 0, "useful_steps": 0}

    @property
    def device(self) -> torch.device:
        return self.model.llm.embed_tokens.weight.device

    def _pick(self, logits, generator: Optional[torch.Generator]):
        if self.do_sample:
            lg = logits / max(self.temperature, 1e-6)
            if self.top_k > 0:
                kth = torch.topk(lg, self.top_k, dim=-1).values[..., -1:]
                lg = torch.where(lg < kth, -1e9, lg)
            return torch.multinomial(torch.softmax(lg, -1), 1, generator=generator)[:, 0]
        return logits.argmax(-1)

    def _init_state(self, batch: Dict[str, torch.Tensor], max_new: int) -> Dict[str, Any]:
        """Prefill -> the decode state on the device."""
        t0 = time.perf_counter()
        model, v = self.model, self.model.cfg.vocab
        L = v.code_layer
        b, _, t = batch["input_ids"].shape
        dev = self.device
        cache = init_kv_cache(model.llm.cache_cfg, b, t + max_new, gen_start=t, device=dev)
        rows = torch.arange(b, device=dev)
        last_idx = _last_valid_index(batch["attention_mask"])  # the collator left-pads
        a_cache = None
        if model.cfg.tts_adapter:
            a_cache = init_kv_cache(model.adapter_cache_cfg, b, t + max_new, gen_start=t, device=dev)
            xt_all, xa_all, cache, a_cache = model.prefill_tts(batch, cache, a_cache)
            next_xt, next_xa = xt_all[rows, last_idx], xa_all[:, rows, last_idx]
        else:
            logits, cache = model.prefill(batch, cache)
            next_xt, next_xa = model.split_logits(logits[rows, last_idx])
        out = torch.full((b, L + 1, max_new), v.pad_a, dtype=torch.int64, device=dev)
        out[:, L] = v.pad_t
        state = dict(
            i=0, useful=0, xt=next_xt, xa=next_xa, cache=cache, a_cache=a_cache, out=out,
            text_end=torch.zeros(b, dtype=torch.bool, device=dev), audio_end=torch.zeros(b, dtype=torch.bool,
                                                                                           device=dev),
            text_counts=torch.zeros(b, v.padded_text_vocabsize, dtype=torch.int32, device=dev),
            audio_counts=torch.zeros(b, L, v.padded_audio_vocabsize, dtype=torch.int32, device=dev),
            t=t, max_new=max_new, prompt_len=batch["attention_mask"].sum(1).to(torch.int64),
            prompt_valid=torch.nn.functional.pad(batch["attention_mask"].bool(), (0, max_new)),
        )
        _sync(dev)
        self.stats["prefill_s"] += time.perf_counter() - t0
        return state

    def _running(self, state: Dict[str, Any]) -> torch.Tensor:
        """Whether any of this rank's rows still runs."""
        return ~(state["text_end"] & state["audio_end"]).all()

    def _run_until(self, state: Dict[str, Any], limit: int, generator: Optional[torch.Generator]) -> None:
        """Advance the state to step ``limit`` or until every row ended (of
        every data rank, in lockstep)."""
        t0 = time.perf_counter()
        v = self.model.cfg.vocab
        L, t, dev = v.code_layer, state["t"], self.device
        b = state["out"].shape[0]
        rows = torch.arange(b, device=dev)
        cols = torch.arange(t + state["max_new"], device=dev)[None, :]
        while state["i"] < limit:
            live = bool(self._running(state))  # the step's one read of the device
            if not all_running(live, self.mesh, dev):
                break
            i = state["i"]
            if not live:  # only another rank's rows run on: step with these frozen
                pads = torch.tensor([int(v.layershift(np.int64(v.pad_a), layer)) for layer in range(L)] + [v.pad_t],
                                    device=dev)
                self._step(state, pads.expand(b, -1), cols)
                self.stats["decode_steps"] += 1
                continue
            was_text_end = state["text_end"]
            tok_t = self._pick(_apply_repetition_penalty(state["xt"], state["text_counts"], self.text_rp), generator)
            tok_t = torch.where(was_text_end, v.pad_t, tok_t)
            # a step samples audio unless it ended, is in the latency window or
            # decodes text only: forced pads stay out of the penalty counts
            sampled_a = ~state["audio_end"] if not (i < self.num_latency_tokens or self.decode_text_only) \
                else torch.zeros(b, dtype=torch.bool, device=dev)
            toks_a = []
            for layer in range(L):
                lg = _apply_repetition_penalty(state["xa"][layer], state["audio_counts"][:, layer], self.audio_rp)
                toks_a.append(torch.where(sampled_a, self._pick(lg, generator), v.pad_a))
            tok_a = torch.stack(toks_a, dim=1)  # (B, L)
            state["text_end"] = was_text_end | (tok_t == v.eot)
            state["audio_end"] = state["audio_end"] | (tok_a == v.eoa).any(dim=1) | self.decode_text_only
            state["out"][:, L, i] = tok_t
            state["out"][:, :L, i] = tok_a
            state["text_counts"][rows, tok_t] += (~was_text_end).to(torch.int32)
            for layer in range(L):
                state["audio_counts"][rows, layer, tok_a[:, layer]] += sampled_a.to(torch.int32)
            shifted = torch.stack([v.layershift(tok_a[:, layer], layer) for layer in range(L)] + [tok_t], dim=1)
            self._step(state, shifted, cols)
            state["useful"] = i + 1
            self.stats["decode_steps"] += 1
            self.stats["useful_steps"] += 1
        _sync(dev)
        self.stats["decode_s"] += time.perf_counter() - t0

    def _step(self, state: Dict[str, Any], shifted: torch.Tensor, cols: torch.Tensor) -> None:
        """One model step at ``state["i"]`` on the layershifted tokens
        ``shifted`` (B, L+1): the next logits into the state."""
        model, i, t = self.model, state["i"], state["t"]
        pos = (state["prompt_len"] + i)[:, None]
        step_mask = (state["prompt_valid"] | ((cols >= t) & (cols <= t + i))).to(torch.int32)
        if model.cfg.tts_adapter:
            xt, xa, state["cache"], state["a_cache"] = model.decode_step_tts(
                shifted, state["cache"], state["a_cache"], t + i, step_mask, pos)
            state["xt"], state["xa"] = xt[:, 0], xa[:, :, 0]
        else:
            logits, state["cache"] = model.decode_step(shifted, state["cache"], t + i, step_mask, pos)
            state["xt"], state["xa"] = model.split_logits(logits[:, 0])
        state["i"] = i + 1

    def _log_lockstep(self, state: Dict[str, Any]) -> None:
        if self.mesh is not None:
            logging.getLogger("slam_llm_tpu_torch").info(
                "lockstep decode: %d steps, this rank's last useful step %d", state["i"], state["useful"])

    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(x).to(self.device) for k, x in batch.items() if k in _BATCH_KEYS}

    def generate(self, batch, generator: Optional[torch.Generator] = None,
                 max_new_tokens: Optional[int] = None) -> np.ndarray:
        """Tokens (B, L+1, max_new): the audio streams (unshifted codebook ids,
        pad_a-filled) and then the text stream (pad_t-filled)."""
        max_new = max_new_tokens or self.max_new_tokens
        with decode_mode(self.model), sharded_decode(self.model):
            state = self._init_state(self._device_batch(batch), max_new)
            self._run_until(state, max_new, generator)
        self._log_lockstep(state)
        return state["out"].cpu().numpy()

    def stream_generate(self, batch, generator: Optional[torch.Generator] = None, stream_stride: int = 24,
                        max_new_tokens: Optional[int] = None, codec_decoder=None) -> Iterator[Dict[str, Any]]:
        """Yields ``{"audio_tokens": (B, L, n), "text_tokens": (B, n), "audio":
        wav?}`` every ``stream_stride`` steps (the reference's
        stream_generate, slam_model_s2s.py:456-634); the decode state stays on
        the device between chunks. A SNAC codec decodes the newly complete
        frames against the whole trimmed history; another codec decodes
        each chunk's tokens. A codec failure raises."""
        with sharded_decode(self.model):
            yield from self._stream(batch, generator, stream_stride, max_new_tokens or self.max_new_tokens,
                                    codec_decoder)

    def _stream(self, batch, generator, stream_stride: int, max_new: int, codec_decoder):
        v = self.model.cfg.vocab
        L = v.code_layer
        with decode_mode(self.model):
            state = self._init_state(self._device_batch(batch), max_new)
        start = frames_done = 0
        while start < max_new:
            n = min(stream_stride, max_new - start)
            with decode_mode(self.model):
                self._run_until(state, start + n, generator)
            out = state["out"].cpu().numpy()
            steps = start + n
            done = not all_running(bool(self._running(state)), self.mesh, self.device)
            payload = {"audio_tokens": out[:, :L, start:steps], "text_tokens": out[:, L, start:steps]}
            if codec_decoder is not None and getattr(codec_decoder, "codec_type", "snac") == "snac":
                # layer j's token for frame f sits at step f + j + 1: decode the
                # new frames against the FULL history, trimmed at audio EOS so
                # the pad / EOA tail is never vocoded
                streams = np.stack(trim_generated(out[0, :, :steps], v)[:L])
                avail = codec_decoder.num_frames(streams)
                payload["audio"] = codec_decoder.decode_window(streams, frames_done, avail)
                frames_done = max(frames_done, avail)
            elif codec_decoder is not None:
                payload["audio"] = codec_decoder.decode(payload["audio_tokens"][0])
            yield payload
            start += n
            if done:
                break
        self._log_lockstep(state)


def trim_generated(tokens: np.ndarray, vocab: VocabConfig) -> List[np.ndarray]:
    """Host side: text cut at EOT, audio streams at the end of audio (the
    reference's slam_model_s2s.py:435-448). tokens: (L+1, T) of one sample.
    Every audio layer freezes to pads once ANY layer emits EOA, so the end
    is the last layer's EOA if present, else the first EOA in any layer,
    else the end of the non-pad audio."""
    L = vocab.code_layer
    text = tokens[L]
    eot_pos = np.where(text == vocab.eot)[0]
    text_out = text[: eot_pos[0]] if eot_pos.size else text
    eoa_pos = np.where(tokens[L - 1] == vocab.eoa)[0]
    if eoa_pos.size:
        end = eoa_pos[0]
    else:
        any_eoa = np.where((tokens[:L] == vocab.eoa).any(axis=0))[0]
        if any_eoa.size:
            end = any_eoa[0]
        else:
            nonpad = np.where((tokens[:L] != vocab.pad_a).any(axis=0))[0]
            end = nonpad[-1] + 1 if nonpad.size else 0
    return [tokens[i][:end] for i in range(L)] + [text_out]


# ---------------------------------------------------------------------------
# the recipe's model factory
# ---------------------------------------------------------------------------


def model_factory(train_config, model_config, device=None, **kwargs):
    """``(S2SModel, tokenizer)`` with zero-filled weights on ``device``: the
    port's copy of ``examples/s2s/model/slam_model_s2s.py:model_factory``
    (``pipeline.common.materialize_params`` fills the weights)."""
    from slam_llm_tpu_torch.data.tokenizer import load_tokenizer
    from slam_llm_tpu_torch.models.whisper import PRESETS as WHISPER_PRESETS

    tokenizer = load_tokenizer(model_config.llm_path)
    vocab = VocabConfig(
        text_vocabsize=getattr(model_config, "text_vocabsize", tokenizer.vocab_size),
        code_layer=getattr(model_config, "code_layer", 3),
        audio_vocabsize=getattr(model_config, "audio_vocabsize", 4096),
    )
    llm_presets = {"qwen2-7b": LLMConfig.qwen2_7b, "tinyllama-1.1b": LLMConfig.tinyllama_1_1b,
                   "tiny-test": LLMConfig.tiny_test}
    llm_cfg = llm_presets.get(model_config.llm_name, LLMConfig.tiny_test)()
    enc_cfg = WHISPER_PRESETS[model_config.encoder_config or "whisper-small"]()
    proj_cfg = ProjectorConfig(encoder_dim=enc_cfg.d_model, llm_dim=llm_cfg.d_model,
                               ds_rate=model_config.encoder_projector_ds_rate)
    cfg = S2SConfig(
        llm=llm_cfg, vocab=vocab, encoder_name="whisper", encoder=enc_cfg, projector=model_config.encoder_projector,
        projector_cfg=proj_cfg, group_decode=getattr(model_config, "group_decode", vocab.code_layer > 1),
        freeze_encoder=train_config.freeze_encoder, freeze_llm=train_config.freeze_llm,
        tts_adapter=getattr(model_config, "tts_adapter", False),
        tts_adapter_layers=getattr(model_config, "tts_adapter_layers", 6),
        train_embed_only=getattr(train_config, "train_embed_only", False),
        train_audio_embed_only=getattr(train_config, "train_audio_embed_only", False),
        train_embed=getattr(train_config, "train_embed", False),
    )
    return S2SModel(cfg, device), tokenizer
