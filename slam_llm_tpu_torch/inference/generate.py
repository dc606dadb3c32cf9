"""Prefill + greedy / sampling / beam decode with a KV cache.

Counterpart of ``slam_llm_tpu/inference/generate.py``. The reference's
``lax.while_loop`` bodies become Python loops with the same exit conditions;
the cache is the split prefix / generated-tail layout of ``models.llm``.
Beam search keeps the reference's HF-4.57 semantics, including its tie
order: ``jax.lax.top_k`` puts the lower index first among equal values,
which ``_top_k`` reproduces with a stable descending sort (``torch.topk``
promises no order among ties).

A model sharded over ``fsdp`` (``Generator(..., mesh=mesh)``) decodes in
lockstep: every data rank takes the same number of steps, since each step's
layer units gather their parameters over them. The loops' stop tests are
global (``parallel.sharding.all_running``), as the reference's while-loop
test over a batch sharded across devices is; a rank whose rows have all
ended keeps stepping with them frozen (its tokens do not change).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from slam_llm_tpu_torch.models.llm import init_kv_cache, reorder_cache
from slam_llm_tpu_torch.parallel.sharding import all_running, sharded_decode, under_fsdp

NEG_INF = -1.0e9
_BATCH_KEYS = ("input_ids", "attention_mask", "modality_mask", "audio_mel", "audio_mel_mask", "audio", "audio_mask",
               "audio_binaural",  # spatial_ast's (B, 4, frames, mels) feature map
               "visual", "visual_mask", "audio_feats",  # av_hubert's frames, frame mask and stacked fbank
               "text_input_ids", "text_input_mask")  # the hf-text encoder's


@dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 200
    num_beams: int = 4
    num_return_sequences: int = 1  # beam only: top-N finished hypotheses per row
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    length_penalty: float = 1.0
    eos_token_id: int = 2
    pad_token_id: int = 0
    bos_token_id: int = 1


def _top_k(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties broken by lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _last_valid_index(attention_mask: torch.Tensor) -> torch.Tensor:
    """Index of the last valid position per row (prompts are left-padded)."""
    t = attention_mask.shape[1]
    return t - 1 - attention_mask.flip(1).to(torch.int32).argmax(dim=1)


def _prompt_token_counts(batch, vocab: int) -> torch.Tensor:
    """Occurrence counts of real prompt tokens for the repetition penalty;
    audio pseudo-tokens (id -1) and padding do not count."""
    ids_raw = batch["input_ids"]
    valid = (batch["attention_mask"] > 0) & (ids_raw >= 0)
    counts = torch.zeros(ids_raw.shape[0], vocab, dtype=torch.int32, device=ids_raw.device)
    return counts.scatter_add_(1, ids_raw.clamp_min(0), valid.to(torch.int32))


def _apply_repetition_penalty(logits, token_counts, penalty):
    """HF CTRL-style: positive logits / p, negative * p, on seen tokens."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(token_counts > 0, penalized, logits)


def _mask_top_k(logits, k):
    if k <= 0:
        return logits
    kth = torch.sort(logits, dim=-1).values[..., -k][..., None]
    return torch.where(logits < kth, NEG_INF, logits)


def _mask_top_p(logits, p):
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = probs.cumsum(-1)
    # keep tokens until the cumulative probability passes p (always the top one)
    cutoff = torch.where(cum - probs > p, torch.inf, sorted_logits).amin(-1, keepdim=True)
    return torch.where(logits < cutoff, NEG_INF, logits)


def _add_one(counts: torch.Tensor, tokens: torch.Tensor) -> None:
    counts[torch.arange(counts.shape[0], device=counts.device), tokens] += 1


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Generator:
    """Binds a ``SLAMModel`` and a ``GenerationConfig``; ``mesh``: the
    ``(dp, fsdp, tp)`` mesh of a model sharded over fsdp (``shard_params``),
    whose data ranks decode in lockstep.

    ``stats`` accumulates over calls: ``prefill_s`` and ``decode_s`` (host
    clock around device-synchronised work), ``decode_steps`` (model decode
    steps run), ``useful_steps`` (those this rank's rows needed: fewer than
    ``decode_steps`` where another rank ran on) and ``calls``.
    """

    def __init__(self, model, gen_cfg: GenerationConfig, mesh=None):
        self.model = model
        self.cfg = gen_cfg
        self.mesh = mesh
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0, "decode_steps": 0, "useful_steps": 0, "calls": 0}
        self._warned_beam_sample = False

    def _log_lockstep(self, steps: int, useful: int) -> None:
        if self.mesh is not None:
            logging.getLogger("slam_llm_tpu_torch").info(
                "lockstep decode: %d steps, this rank's last useful step %d", steps, useful)

    @property
    def device(self) -> torch.device:
        return self.model.llm.embed_tokens.weight.device

    def _prefill(self, batch, max_new: int):
        b, t = batch["input_ids"].shape
        t0 = time.perf_counter()
        # split layout: decode writes touch only the [t, t + max_new) tail
        cache = init_kv_cache(
            self.model.llm.cache_cfg, b, t + max_new, gen_start=t, device=self.device
        )
        logits, cache = self.model.prefill(batch, cache)
        # the last VALID position seeds the first generated token
        last_idx = _last_valid_index(batch["attention_mask"])
        next_logits = logits[torch.arange(b, device=logits.device), last_idx]
        # RoPE positions are a cumsum over the mask: the next position is the
        # valid-token count, not last_idx + 1
        prompt_len = batch["attention_mask"].sum(1).to(torch.int64)
        _sync(self.device)
        self.stats["prefill_s"] += time.perf_counter() - t0
        return cache, next_logits, prompt_len, logits.shape[-1]

    # ---- sampling / greedy -----------------------------------------------

    def _greedy(self, batch, max_new: int, generator: Optional[torch.Generator]):
        cfg = self.cfg
        b, t = batch["input_ids"].shape
        max_len = t + max_new
        dev = self.device
        cache, next_logits, prompt_len, vocab = self._prefill(batch, max_new)
        token_counts = _prompt_token_counts(batch, vocab)

        def pick(lg, counts):
            lg = _apply_repetition_penalty(lg, counts, cfg.repetition_penalty)
            if cfg.do_sample:
                lg = lg / max(cfg.temperature, 1e-6)
                lg = _mask_top_p(_mask_top_k(lg, cfg.top_k), cfg.top_p)
                return torch.multinomial(torch.softmax(lg, -1), 1, generator=generator)[:, 0]
            return lg.argmax(-1)

        t0 = time.perf_counter()
        out_tokens = torch.full((b, max_new), cfg.pad_token_id, dtype=torch.int64, device=dev)
        tok = pick(next_logits, token_counts)
        out_tokens[:, 0] = tok
        finished = tok == cfg.eos_token_id
        _add_one(token_counts, tok)
        cols = torch.arange(max_len, device=dev)[None, :]
        prompt_valid = torch.nn.functional.pad(batch["attention_mask"].bool(), (0, max_len - t))

        i, useful = 1, 0
        while i < max_new:
            live = not bool(finished.all())  # the step's one read of the device
            if not all_running(live, self.mesh, dev):
                break
            prev = out_tokens[:, i - 1 : i]
            pos = (prompt_len + i - 1)[:, None]
            cache_index = t + i - 1  # write slot: prompt bucket + i - 1
            step_mask = (prompt_valid | ((cols >= t) & (cols <= t + i - 1))).to(torch.int32)
            logits, cache = self.model.decode_step(prev, cache, cache_index, step_mask, pos)
            if live:  # else only another rank's rows run on
                tok = pick(logits[:, 0], token_counts)
                tok = torch.where(finished, cfg.pad_token_id, tok)
                out_tokens[:, i] = tok
                finished = finished | (tok == cfg.eos_token_id)
                _add_one(token_counts, tok)
                useful = i
            i += 1
            self.stats["decode_steps"] += 1
        self.stats["useful_steps"] += useful
        self._log_lockstep(i - 1, useful)
        _sync(dev)
        self.stats["decode_s"] += time.perf_counter() - t0
        return out_tokens

    # ---- beam search -------------------------------------------------------

    def _beam(self, batch, max_new: int, num_beams: int):
        """Length-penalized beam search with HF ``_beam_search`` semantics
        (see the reference's ``Generator._beam``): 2K candidates per step, the
        K best that hit no stopping criterion continue, rank < K hits bank
        with score ``cum_logprob / gen_len ** length_penalty``, a sticky
        per-row early stop, and the best finished beam is returned."""
        cfg = self.cfg
        b, t = batch["input_ids"].shape
        k, k2 = num_beams, 2 * num_beams
        max_len = t + max_new
        lp = cfg.length_penalty
        dev = self.device
        cache, next_logits, prompt_len, v = self._prefill(batch, max_new)

        t0 = time.perf_counter()
        if self.model.cfg.llm.prefix_len:
            # prefix-tuning prepends its slots inside the attention, which
            # needs the prompt cache tiled to the beams, as in the reference
            cache = {key: val.repeat_interleave(k, dim=1) for key, val in cache.items()}
        else:
            # beams share the prompt prefix: keep "k"/"v" at B rows and give
            # each beam its own generated tail
            cache = {
                "k": cache["k"], "v": cache["v"],
                "k_gen": cache["k_gen"].new_zeros((cache["k_gen"].shape[0], b * k) + cache["k_gen"].shape[2:]),
                "v_gen": cache["v_gen"].new_zeros((cache["v_gen"].shape[0], b * k) + cache["v_gen"].shape[2:]),
            }
        att = batch["attention_mask"].repeat_interleave(k, dim=0)  # (B*K, t)
        prompt_len_k = prompt_len.repeat_interleave(k, dim=0)
        counts0 = _prompt_token_counts(batch, v)
        top_beam_mask = torch.arange(k2, device=dev) < k  # rank < K may bank
        rows = torch.arange(b, device=dev)

        def norm_len(i):
            return torch.tensor(float(i + 1), dtype=torch.float32, device=dev) ** lp

        def gather_seq(seq, idx):  # (B, N, L) rows picked by idx (B, M)
            return torch.gather(seq, 1, idx[:, :, None].expand(-1, -1, seq.shape[2]))

        def process(i, run_scores, run_tokens, logp, fin, unsat):
            fin_tokens, fin_scores, fin_flags = fin
            cand = run_scores[:, :, None] + logp  # (B, K, V)
            # exact top-2K in two stages: the global top-2K is a subset of the
            # per-beam top-2Ks; merge rows keep beams in flat-index order
            s_pb, i_pb = _top_k(cand.reshape(b * k, v), k2)
            beam_base = (torch.arange(b * k, device=dev) % k)[:, None] * v
            c_scores, sel2 = _top_k(s_pb.reshape(b, k * k2), k2)
            c_idx = torch.gather((i_pb + beam_base).reshape(b, k * k2), 1, sel2)
            c_src = c_idx // v
            c_tok = c_idx % v
            c_seq = gather_seq(run_tokens, c_src)
            c_seq[:, :, i] = c_tok
            hits = c_tok == cfg.eos_token_id
            if i + 1 >= max_new:  # max length: every candidate stops
                hits = torch.ones_like(hits)

            new_run_scores, sel = _top_k(c_scores + hits.float() * -1.0e9, k)
            new_run_tokens = gather_seq(c_seq, sel)
            sel_src = torch.gather(c_src, 1, sel)

            norm = c_scores / norm_len(i)
            banks = hits & top_beam_mask[None, :]
            norm = torch.where(banks & unsat[:, None], norm, -1.0e9)
            m_scores = torch.cat([fin_scores, norm], dim=1)
            m_tokens = torch.cat([fin_tokens, c_seq], dim=1)
            m_flags = torch.cat([fin_flags, banks], dim=1)
            new_fin_scores, keep = _top_k(m_scores, k)
            new_fin_tokens = gather_seq(m_tokens, keep)
            new_fin_flags = torch.gather(m_flags, 1, keep)

            best_possible = new_run_scores[:, :1] / norm_len(i)
            worst_fin = torch.where(
                new_fin_flags, new_fin_scores.amin(1, keepdim=True), -1.0e9
            )
            new_unsat = unsat & (best_possible > worst_fin).any(-1)
            return (new_run_scores, new_run_tokens, sel_src, hits,
                    (new_fin_tokens, new_fin_scores, new_fin_flags), new_unsat)

        # step 0 from the prefill logits; running scores [0, -1e9, ...] make
        # beam 0 the only source
        logp0 = _apply_repetition_penalty(
            torch.log_softmax(next_logits, -1), counts0, cfg.repetition_penalty
        )
        run_scores = torch.full((b, k), -1.0e9, device=dev)
        run_scores[:, 0] = 0.0
        run_tokens = torch.full((b, k, max_new), cfg.pad_token_id, dtype=torch.int64, device=dev)
        fin = (
            torch.full((b, k, max_new), cfg.pad_token_id, dtype=torch.int64, device=dev),
            torch.full((b, k), -1.0e9, device=dev),
            torch.zeros((b, k), dtype=torch.bool, device=dev),
        )
        run_scores, run_tokens, sel_src, hits, fin, unsat = process(
            0, run_scores, run_tokens, logp0[:, None, :].expand(b, k, v), fin,
            torch.ones(b, dtype=torch.bool, device=dev),
        )
        token_counts = counts0.repeat_interleave(k, dim=0)
        _add_one(token_counts, run_tokens[:, :, 0].reshape(-1))
        cols = torch.arange(max_len, device=dev)[None, :]
        prompt_valid = torch.nn.functional.pad(att.bool(), (0, max_len - t))

        i, useful = 1, 0
        while i < max_new:
            live = bool(unsat.any()) and not bool(hits.all())
            if not all_running(live, self.mesh, dev):
                break
            tok = run_tokens[:, :, i - 1].reshape(b * k)
            pos = (prompt_len_k + i - 1)[:, None]
            cache_index = t + i - 1
            step_mask = (prompt_valid | ((cols >= t) & (cols <= t + i - 1))).to(torch.int32)
            logits, cache = self.model.decode_step(tok[:, None], cache, cache_index, step_mask, pos)
            if live:  # else only another rank's rows run on
                logp = _apply_repetition_penalty(
                    torch.log_softmax(logits[:, 0], -1), token_counts, cfg.repetition_penalty
                )
                run_scores, run_tokens, sel_src, hits, fin, unsat = process(
                    i, run_scores, run_tokens, logp.reshape(b, k, v), fin, unsat
                )
                flat_src = (rows[:, None] * k + sel_src).reshape(b * k)
                cache = reorder_cache(cache, flat_src)
                token_counts = token_counts[flat_src]
                _add_one(token_counts, run_tokens[:, :, i].reshape(-1))
                useful = i
            i += 1
            self.stats["decode_steps"] += 1
        self.stats["useful_steps"] += useful
        self._log_lockstep(i - 1, useful)
        _sync(dev)
        self.stats["decode_s"] += time.perf_counter() - t0
        # finished scores stay sorted by the top-k merge: beam 0 is best
        n = min(max(1, cfg.num_return_sequences), k)
        if n == 1:
            return fin[0][:, 0]
        return fin[0][:, :n].reshape(b * n, max_new)

    # ---- public API -------------------------------------------------------

    def generate(
        self,
        batch: Dict[str, object],
        generator: Optional[torch.Generator] = None,
        max_new_tokens: Optional[int] = None,
    ) -> np.ndarray:
        """Token ids (B, max_new) (B * num_return_sequences rows for beam),
        pad-filled after EOS. ``generator`` drives sampling."""
        with decode_mode(self.model), sharded_decode(self.model):
            return self._generate(batch, generator, max_new_tokens)

    def _generate(self, batch, generator, max_new_tokens) -> np.ndarray:
        cfg = self.cfg
        max_new = cfg.max_new_tokens if max_new_tokens is None else max_new_tokens
        dev = self.device
        batch = {
            key: torch.as_tensor(val).to(dev)
            for key, val in batch.items()
            if key in _BATCH_KEYS
        }
        self.stats["calls"] += 1
        if cfg.num_beams > 1 and not cfg.do_sample:
            out = self._beam(batch, max_new, cfg.num_beams)
        else:
            if cfg.num_beams > 1 and not self._warned_beam_sample:
                logging.getLogger("slam_llm_tpu_torch").warning(
                    "num_beams=%d with do_sample=True: beam-multinomial sampling is not "
                    "implemented, sampling a single sequence instead", cfg.num_beams,
                )
                self._warned_beam_sample = True
            out = self._greedy(batch, max_new, generator)
        return out.cpu().numpy()


def decode_mode(model):
    """``torch.inference_mode()``; ``torch.no_grad()`` for a model under
    FSDP2. Its gathers run under inference mode too, but the unsharded
    parameters FSDP2 allocates on first use (and keeps, resizing their
    storage) would be inference tensors, which a later training forward of
    the same model could not save for backward."""
    return torch.no_grad() if under_fsdp(model) else torch.inference_mode()


def strip_after_eos(tokens: np.ndarray, eos_id: int, pad_id: int) -> np.ndarray:
    """Host-side cleanup: pad everything from the first EOS on."""
    out = tokens.copy()
    for row in out:
        hits = np.where(row == eos_id)[0]
        if hits.size:
            row[hits[0]:] = pad_id
    return out
