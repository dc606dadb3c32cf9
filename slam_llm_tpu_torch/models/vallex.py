"""VALL-E X zero-shot TTS: AR + NAR transformers over EnCodec tokens.

Counterpart of ``slam_llm_tpu/models/vallex.py``; with ``llm_name: vallex``
this model is the whole system (no encoder, projector or LLM).

* AR stage: a causal decoder over ``[text ; codebook-0 audio]``, predicting
  codebook 0 with a supervised end-of-audio (``eos_audio``, also the BOS);
* NAR stage: a bidirectional decoder whose input sums the text embedding and
  the embeddings of the codebooks already known, conditioned on the target
  codebook by a stage embedding through adaptive LayerNorms (``AdaLayerNorm``:
  f32 statistics, scale / bias from the stage embedding, per row);
* training loss: the AR CE on codebook 0 plus the NAR CE on each row's
  ``nar_stage``.

The blocks are pre-LN with biased q / k / v / out projections and exact
GELU. Attention is ``models.layers.mha_attention`` with the structured key
mask ``[text | audio]`` (text padded to its bucket, so the mask has a hole
inside the row): on a CUDA tensor K1 / K4 in bf16 (their f32 routes for an
f32 model). Every tensor trains, so every weight is an f32 master, cast to
the compute dtype at use.

``infer_ar`` samples codebook 0 with top-k from an explicit
``torch.Generator``, re-running the whole AR forward each step at the static
length ``prompt + max_new`` as the reference does; a row's tokens after its
end-of-audio are end-of-audio. ``infer_nar`` fills codebooks 1.. greedily,
keeping the enrolled prompt's true codes.

Under tensor parallelism (``parallel.tensor_parallel.split_vallex``) each
block runs ``n_heads / tp`` heads a rank (q / k / v and fc1 column-parallel,
out_proj and fc2 row-parallel); AdaLN's ``mod`` is column-parallel and its
(B, 2 x d_model) output gathered before the ``[scale | bias]`` chunk; every
embedding holds its rows ``[r V / tp, (r + 1) V / tp)`` (a masked local
lookup, then an exact all-reduce whose backward reaches the rank's rows);
both heads are column-parallel over the audio vocabulary. The loss reads
no whole logits: each CE is vocab-parallel
(``ops.fused_ce.windowed_logits_ce``: one chunk of T gathered at a time for
the logsumexp, the label's logit and the argmax, lowest index first), and
the decodes gather the logits in rank order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from slam_llm_tpu_torch.models.layers import DenseGeneralLora, LayerNorm, mha_attention, sinusoidal_positions
from slam_llm_tpu_torch.ops.fused_ce import windowed_logits_ce
from slam_llm_tpu_torch.parallel.sharding import token_count
from slam_llm_tpu_torch.parallel.tensor_parallel import gather_last, vocab_parallel_lookup


@dataclass(frozen=True)
class VallexConfig:
    text_vocab: int = 512  # phoneme inventory (+ languages)
    audio_vocab: int = 1024
    n_codebooks: int = 8
    d_model: int = 1024
    n_heads: int = 16
    ar_layers: int = 12
    nar_layers: int = 12
    ffn_mult: int = 4
    dtype: torch.dtype = torch.bfloat16

    @property
    def audio_vocab_padded(self) -> int:
        return self.audio_vocab + 8  # end-of-audio and pads

    @property
    def eos_audio(self) -> int:
        return self.audio_vocab

    @staticmethod
    def base_24l() -> "VallexConfig":
        return VallexConfig(ar_layers=24, nar_layers=24)

    @staticmethod
    def tiny_test() -> "VallexConfig":
        return VallexConfig(text_vocab=32, audio_vocab=16, n_codebooks=4, d_model=32, n_heads=2,
                            ar_layers=2, nar_layers=2)


PRESETS = {"vallex": VallexConfig.base_24l, "vallex-tiny-test": VallexConfig.tiny_test}


def _dense(fin: int, fout: int, c: VallexConfig, device, use_bias: bool = True) -> DenseGeneralLora:
    return DenseGeneralLora(fin, fout, use_bias=use_bias, dtype=c.dtype, frozen_base=False, device=device)


class AdaLayerNorm(nn.Module):
    """LayerNorm (f32 statistics, population variance, eps 1e-5) whose scale
    and bias come from the stage embedding through the dense ``mod``."""

    def __init__(self, c: VallexConfig, device=None):
        super().__init__()
        self.dtype = c.dtype
        self.mod = _dense(c.d_model, 2 * c.d_model, c, device)
        self.tp = None  # parallel.tensor_parallel.TP once split over tp

    def forward(self, x: torch.Tensor, stage_emb: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = (x32 - mean).square().mean(-1, keepdim=True)
        norm = (x32 - mean) * torch.rsqrt(var + 1e-5)
        mod = self.mod(stage_emb)
        if self.tp is not None:
            mod = gather_last(mod, self.tp)
        scale, bias = mod.float().chunk(2, dim=-1)  # (B, D) each
        return (norm * (1.0 + scale[:, None, :]) + bias[:, None, :]).to(self.dtype)


class VallexBlock(nn.Module):
    def __init__(self, c: VallexConfig, adaptive: bool, device=None):
        super().__init__()
        self.cfg, self.adaptive = c, adaptive
        for name in ("norm1", "norm2"):
            setattr(self, name, AdaLayerNorm(c, device) if adaptive else LayerNorm(c.d_model, 1e-5, c.dtype, device))
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, _dense(c.d_model, c.d_model, c, device))
        self.fc1 = _dense(c.d_model, c.ffn_mult * c.d_model, c, device)
        self.fc2 = _dense(c.ffn_mult * c.d_model, c.d_model, c, device)
        self.n_heads = c.n_heads  # this rank's heads (n_heads / tp once split)

    def _norm(self, norm: nn.Module, x: torch.Tensor, stage_emb: Optional[torch.Tensor]) -> torch.Tensor:
        return norm(x, stage_emb) if self.adaptive else norm(x)

    def forward(self, x, kv_mask, causal: bool, stage_emb=None):
        c = self.cfg
        b, t, _ = x.shape
        nh, hd = self.n_heads, c.d_model // c.n_heads
        h = self._norm(self.norm1, x, stage_emb)
        q, k, v = (proj(h).reshape(b, t, nh, hd) for proj in (self.q_proj, self.k_proj, self.v_proj))
        attn = mha_attention(q, k, v, kv_mask=kv_mask, causal=causal)
        x = x + self.out_proj(attn.reshape(b, t, nh * hd))
        h = F.gelu(self.fc1(self._norm(self.norm2, x, stage_emb)))
        return x + self.fc2(h)


class VallexStack(nn.Module):
    def __init__(self, c: VallexConfig, n_layers: int, adaptive: bool, device=None):
        super().__init__()
        self.layers = nn.ModuleList(VallexBlock(c, adaptive, device) for _ in range(n_layers))

    def forward(self, x, kv_mask, causal: bool, stage_emb=None):
        for layer in self.layers:
            x = layer(x, kv_mask, causal, stage_emb)
        return x


class VALLE(nn.Module):
    """The reference's names: ``text_embedding``, ``audio_embedding_{i}``,
    ``nar_stage_embedding``, ``ar_decoder`` / ``nar_decoder`` (``layers.{i}``),
    ``ar_norm`` / ``nar_norm``, ``ar_head`` / ``nar_head``."""

    def __init__(self, cfg: VallexConfig, device=None):
        super().__init__()
        c = self.cfg = cfg

        def emb(n):
            return nn.Embedding(n, c.d_model, device=device)

        self.text_embedding = emb(c.text_vocab)
        for i in range(c.n_codebooks):
            setattr(self, f"audio_embedding_{i}", emb(c.audio_vocab_padded))
        self.nar_stage_embedding = emb(c.n_codebooks)
        self.ar_decoder = VallexStack(c, c.ar_layers, False, device)
        self.nar_decoder = VallexStack(c, c.nar_layers, True, device)
        self.ar_head = _dense(c.d_model, c.audio_vocab_padded, c, device, use_bias=False)
        self.nar_head = _dense(c.d_model, c.audio_vocab_padded, c, device, use_bias=False)
        self.ar_norm = LayerNorm(c.d_model, 1e-5, c.dtype, device)
        self.nar_norm = LayerNorm(c.d_model, 1e-5, c.dtype, device)
        self.tp = None  # parallel.tensor_parallel.TP once split over tp

    def _embed(self, table: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
        ids = ids.clamp_min(0)
        rows = F.embedding(ids, table.weight) if self.tp is None else vocab_parallel_lookup(ids, table.weight, self.tp)
        return rows.to(self.cfg.dtype)

    def _logits(self, head: DenseGeneralLora, x: torch.Tensor, local: bool) -> torch.Tensor:
        """f32 logits of ``x``: this rank's columns of the vocabulary under tp
        where ``local``, else whole (gathered in rank order)."""
        out = head(x).float()
        return out if local or self.tp is None else gather_last(out, self.tp)

    def _audio_embedding(self, i: int) -> nn.Embedding:
        return getattr(self, f"audio_embedding_{i}")

    def _pos(self, t: int, device) -> torch.Tensor:
        return sinusoidal_positions(t, self.cfg.d_model, device=device).to(self.cfg.dtype)

    # ---- AR stage ----------------------------------------------------------

    def ar_forward(self, text_ids, text_mask, audio0_ids, audio_mask, local: bool = False) -> torch.Tensor:
        """``[text ; codebook-0 audio]`` through the causal stack -> (B, Ta, V)
        f32 logits at the audio positions (``local``: this rank's V / tp
        columns under tp)."""
        tt, ta = text_ids.shape[1], audio0_ids.shape[1]
        x = torch.cat([self._embed(self.text_embedding, text_ids), self._embed(self.audio_embedding_0, audio0_ids)], 1)
        x = x + self._pos(tt + ta, x.device)[None]
        mask = torch.cat([text_mask, audio_mask], dim=1)
        x = self.ar_norm(self.ar_decoder(x, mask, True))
        return self._logits(self.ar_head, x[:, tt:], local)

    # ---- NAR stage ---------------------------------------------------------

    def nar_forward(self, text_ids, text_mask, audio_ids, audio_mask, stage, prompt_len=None,
                    local: bool = False) -> torch.Tensor:
        """``audio_ids`` (B, n_codebooks, Ta) with the codebooks below each
        row's ``stage`` (B,) known -> f32 logits of codebook ``stage``
        (``local`` as in ``ar_forward``). At positions below ``prompt_len``
        (B,), the enrolled prompt, every codebook is summed whatever the
        stage."""
        c = self.cfg
        b, _, ta = audio_ids.shape
        tt = text_ids.shape[1]
        cols = torch.arange(ta, device=audio_ids.device)[None, :]
        is_prompt = cols < prompt_len[:, None] if prompt_len is not None else torch.zeros_like(cols, dtype=torch.bool)
        acc = torch.zeros((b, ta, c.d_model), dtype=c.dtype, device=audio_ids.device)
        for i in range(c.n_codebooks):
            known = ((i < stage)[:, None] | is_prompt).to(c.dtype)[..., None]
            acc = acc + known * self._embed(self._audio_embedding(i), audio_ids[:, i])
        x = torch.cat([self._embed(self.text_embedding, text_ids), acc], dim=1)
        x = x + self._pos(tt + ta, x.device)[None]
        stage_emb = self._embed(self.nar_stage_embedding, stage)  # (B, D)
        mask = torch.cat([text_mask, audio_mask], dim=1)
        x = self.nar_norm(self.nar_decoder(x, mask, False, stage_emb))
        return self._logits(self.nar_head, x[:, tt:], local)

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``{"loss", "acc", "ar_loss", "nar_loss"}``: the AR CE on codebook 0
        (input shifted right behind the BOS, the end-of-audio supervised at
        each row's length in an extra column) plus the NAR CE on
        ``batch["nar_stage"]``; ``acc`` is the AR's."""
        c = self.cfg
        text_ids, text_mask = batch["text_ids"], batch["text_mask"]
        audio_ids, audio_mask, stage = batch["audio_ids"], batch["audio_mask"], batch["nar_stage"]
        if audio_ids.shape[1] != c.n_codebooks:
            raise ValueError(f"the batch carries {audio_ids.shape[1]} codebooks, the model {c.n_codebooks}: set "
                             f"dataset_config.code_layer={c.n_codebooks}")
        a0 = audio_ids[:, 0]
        b = a0.shape[0]
        rows = torch.arange(b, device=a0.device)
        lens = audio_mask.sum(1).long()
        a0_ext = F.pad(a0, (0, 1))
        a0_ext[rows, lens] = c.eos_audio
        mask_ext = F.pad(audio_mask, (0, 1))
        mask_ext[rows, lens] = 1
        ar_in = torch.cat([torch.full_like(a0[:, :1], c.eos_audio), a0_ext[:, :-1]], dim=1)
        local = self.tp is not None
        ar_logits = self.ar_forward(text_ids, text_mask, ar_in, mask_ext, local=local)
        if local:
            ar_loss, acc = self._vocab_parallel_ce(ar_logits, a0_ext, mask_ext)
        else:
            mask_f = mask_ext.float()
            denom = token_count(mask_f)
            ar_loss = (_nll(ar_logits, a0_ext) * mask_f).sum() / denom
            acc = ((ar_logits.argmax(-1) == a0_ext).float() * mask_f).sum() / denom

        if c.n_codebooks > 1:
            nar_logits = self.nar_forward(text_ids, text_mask, audio_ids, audio_mask, stage, local=local)
            target = audio_ids[rows, stage.long()]
            if local:
                nar_loss = self._vocab_parallel_ce(nar_logits, target, audio_mask)[0]
            else:
                nar_mask = audio_mask.float()
                nar_loss = (_nll(nar_logits, target) * nar_mask).sum() / token_count(nar_mask)
        else:  # one codebook: the NAR branch would be a copy task
            nar_loss = torch.zeros((), device=a0.device)
        return {"loss": ar_loss + nar_loss, "acc": acc.detach(), "ar_loss": ar_loss, "nar_loss": nar_loss}

    def _vocab_parallel_ce(self, local_logits, target, mask):
        """The masked-mean CE and accuracy of this rank's vocabulary columns
        of the logits, over the whole vocabulary (``windowed_logits_ce``)."""
        labels = torch.where(mask.bool(), target.long(), torch.full_like(target.long(), -100))
        loss, acc = windowed_logits_ce(local_logits, [labels], [(0, self.cfg.audio_vocab_padded)], tp=self.tp)
        return loss[0], acc[0]

    # ---- inference ---------------------------------------------------------

    @torch.no_grad()
    def infer_ar(self, text_ids, text_mask, prompt_audio0, prompt_len, max_new: int,
                 generator: Optional[torch.Generator] = None, top_k: int = 50, temperature: float = 1.0
                 ) -> torch.Tensor:
        """Codebook 0 of ``prompt + max_new`` frames (B, total): the prompt,
        then tokens sampled from the top ``top_k`` at ``temperature``, one
        whole AR forward a step; a finished row continues with end-of-audio.
        Stops early once every row has finished (the rest would be
        end-of-audio)."""
        c = self.cfg
        b, tp = prompt_audio0.shape
        total = tp + max_new
        dev = text_ids.device
        audio = torch.full((b, total), c.eos_audio, dtype=torch.int64, device=dev)
        audio[:, :tp] = prompt_audio0
        bos = torch.full((b, 1), c.eos_audio, dtype=torch.int64, device=dev)
        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        cols = torch.arange(total, device=dev)[None, :]
        rows = torch.arange(b, device=dev)
        for i in range(max_new):
            pos = prompt_len + i  # (B,)
            a_mask = (cols < (pos + 1)[:, None]).to(torch.int32)
            logits = self.ar_forward(text_ids, text_mask, torch.cat([bos, audio[:, :-1]], dim=1), a_mask)
            lg = logits[rows, pos] / max(temperature, 1e-6)
            if top_k > 0:
                kth = torch.sort(lg, dim=-1).values[..., -top_k][..., None]
                lg = torch.where(lg < kth, -1e9, lg)
            tok = torch.multinomial(torch.softmax(lg, dim=-1), 1, generator=generator)[:, 0]
            tok = torch.where(finished, c.eos_audio, tok)
            finished = finished | (tok == c.eos_audio)
            audio[rows, pos] = tok
            if bool(finished.all()):
                break
        return audio

    @torch.no_grad()
    def infer_nar(self, text_ids, text_mask, audio_ids, audio_mask, prompt_len=None) -> torch.Tensor:
        """Codebooks 1.. filled greedily, one NAR forward each; positions below
        ``prompt_len`` keep their codes."""
        c = self.cfg
        b, _, ta = audio_ids.shape
        audio_ids = audio_ids.clone()
        cols = torch.arange(ta, device=audio_ids.device)[None, :]
        keep = cols < prompt_len[:, None] if prompt_len is not None else torch.zeros_like(cols, dtype=torch.bool)
        for stage in range(1, c.n_codebooks):
            stage_arr = torch.full((b,), stage, dtype=torch.int64, device=audio_ids.device)
            pred = self.nar_forward(text_ids, text_mask, audio_ids, audio_mask, stage_arr, prompt_len).argmax(-1)
            audio_ids[:, stage] = torch.where(keep, audio_ids[:, stage], pred)
        return audio_ids


def _nll(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """-log_softmax(logits)[target] per position (f32)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, target.clamp_min(0).long()[..., None])[..., 0]

