"""S2S (SLAM-Omni) inference drivers: online, multi-round, batch, streaming.

Counterpart of ``slam_llm_tpu/pipeline/generate_s2s.py`` (the reference's
``examples/s2s/generate/generate_s2s_{batch,online}[_multi_round|_stream]``):
one session object, and ``decode_config.mode`` picks the driver. Speech is
synthesized when ``model_config.codec_decoder_path`` names a SNAC
checkpoint or a CosyVoice pair (``codec_decoder_type``): a directory
holding ``flow.pt`` and ``hift.pt``, or ``flow.pt:hift.pt``. A codec that
fails to load or to decode raises; the JAX package logs and goes on
without audio.

    python -m slam_llm_tpu_torch.pipeline.generate_s2s --config examples/s2s/conf/s2s_qwen.yaml \\
        ++decode_config.mode=batch ++dataset_config.val_data_path=test.jsonl \\
        ++decode_config.decode_log=/tmp/s2s ++model_config.codec_decoder_type=CosyVoice \\
        ++model_config.codec_decoder_path=<dir with flow.pt and hift.pt> [--device cpu]

``mode``: ``online`` (stdin lines: a wav path, or ``t:<text>``),
``online_multi_round`` (history threaded into the prompt),
``online_stream`` (chunks as they decode), ``batch`` (``{decode_log}_pred``
/ ``_gt`` and ``{decode_log}_wav/<key>.wav``). Weights: the seeded random
init, then ``llm_path`` / ``encoder_path`` / ``ckpt_path``
(``pipeline.common.materialize_params``).

Under torchrun the session decodes on the ``(dp, fsdp, tp)`` mesh of
``train_config.shard`` (the JAX package's ``build_mesh``), the model built
straight into each rank's shards (``pipeline.common.materialize_params``):
with ``shard.tp`` it is split (``parallel.tensor_parallel.split_for_tp``),
and the tp ranks of a data rank
decode the same items in lockstep on the same whole logits, each sampling
stream seeded alike (``train_config.seed``, fresh for every generation, as
the JAX package's ``PRNGKey(0)``); only tp rank 0 loads the codec, prints and
writes. With ``shard.fsdp`` the model is sharded as the trainer shards it
(``parallel.shard_params``: FSDP2 over the data ranks), no rank holds a
whole replica, and the data ranks decode in lockstep (global stop tests);
the vocoders stay whole on each writing rank and run no collective. Batch
mode takes the items rank-strided over the data ranks, with ``_rank{r}``
logs where there are several; under fsdp a rank whose share ran out decodes
a wrapped item unwritten, so every rank runs as many decodes. The online
modes read their lines on rank 0 and broadcast them to every rank (the tp
and fsdp ranks serve one dialogue; rank 0 prints and writes); several dp
replicas raise.

    torchrun --nproc_per_node=2 -m slam_llm_tpu_torch.pipeline.generate_s2s --config <yaml> \\
        ++train_config.shard.fsdp=2 ++decode_config.mode=batch ...
"""

from __future__ import annotations

import os
import sys
import time
import wave
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from slam_llm_tpu_torch.config import RunConfig, load_run_config
from slam_llm_tpu_torch.data.s2s_dataset import DEFAULT_S2S_PROMPT, PROMPT_TEMPLATE, header_streams, question_mel
from slam_llm_tpu_torch.data.speech_dataset import bucketize
from slam_llm_tpu_torch.models.s2s import S2SGenerator, VocabConfig, trim_generated
from slam_llm_tpu_torch.ops import audio as audio_ops
from slam_llm_tpu_torch.parallel.sharding import data_rank, data_size, make_mesh
from slam_llm_tpu_torch.parallel.tensor_parallel import tp_of
from slam_llm_tpu_torch.pipeline.common import (
    destroy_process_group,
    build_model,
    materialize_params,
    maybe_init_distributed,
    parse_device,
    resolve_device,
)
from slam_llm_tpu_torch.registry import get_custom_dataset_factory
from slam_llm_tpu_torch.utils.codec_utils import CodecDecoder
from slam_llm_tpu_torch.utils.logging_utils import setup_logger

logger = setup_logger("slam_llm_tpu_torch")

# turn separators, the reference's generate_s2s_online_multi_round.py:120-246
USER_TURN = "USER: {} "
ASSISTANT_TURN = "ASSISTANT: {} "


def write_wav(path: str, wav: np.ndarray, sample_rate: int = 24000) -> None:
    """f32 in [-1, 1] -> a 16-bit PCM wav."""
    pcm = (np.clip(np.asarray(wav, np.float32), -1.0, 1.0) * 32767.0).astype(np.int16)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def build_round_batch(tokenizer, vocab: VocabConfig, system_prompt: str, history: str = "",
                      wav_path: Optional[str] = None, text_input: Optional[str] = None, mel_size: int = 80,
                      max_audio_s: float = 30.0, fix_length_audio: int = -1,
                      text_buckets=(64, 128, 256, 512, 1024)) -> Dict[str, Any]:
    """One dialogue round -> a multi-stream batch of one: the dataset's
    inference layout (``data.s2s_dataset.header_streams``, the history
    folded into the system prompt), audio placeholders for a wav round or
    the text's tokens for a text round, left-padded to a bucket."""
    v, L = vocab, vocab.code_layer
    audio_mel, a_len, text_ids = None, 0, None
    if wav_path is not None:
        audio_mel, a_len, _ = question_mel(wav_path, int(max_audio_s * audio_ops.SAMPLE_RATE), mel_size,
                                           fix_length_audio)
    else:
        text_ids = list(tokenizer.encode(text_input or "", add_bos=False))
    streams, p_len = header_streams(tokenizer, v, PROMPT_TEMPLATE.format(system_prompt) + history, a_len, text_ids)
    input_ids = np.stack([np.asarray(s, np.int64) for s in streams])  # (L+1, T)
    t = input_ids.shape[1]
    left = bucketize(t, list(text_buckets)) - t
    if left:
        pad_cols = np.stack([np.full(left, int(v.layershift(np.int64(v.pad_a), i)), np.int64) for i in range(L)]
                            + [np.full(left, v.pad_t, np.int64)])
        input_ids = np.concatenate([pad_cols, input_ids], axis=1)
    modality_mask = np.zeros(t + left, np.int32)
    if wav_path is not None:
        modality_mask[left + p_len + 1: left + p_len + 1 + a_len] = 1
    batch = {"input_ids": input_ids[None],
             "attention_mask": np.concatenate([np.zeros(left, np.int32), np.ones(t, np.int32)])[None],
             "modality_mask": modality_mask[None]}
    if audio_mel is not None:
        batch["audio_mel"] = audio_mel[None].astype(np.float32)
        batch["audio_mel_mask"] = np.ones((1, audio_mel.shape[0]), np.int32)
    return batch


def load_codec(cfg: RunConfig, device) -> Optional[CodecDecoder]:
    """The vocoder ``model_config.codec_decoder_path`` names, on ``device``;
    None without a path. A path that does not load raises."""
    mc = cfg.model_config
    path = getattr(mc, "codec_decoder_path", None)
    if not path:
        return None
    ctype = getattr(mc, "codec_decoder_type", "SNAC")
    if ctype.upper() == "SNAC":
        return CodecDecoder.from_snac_checkpoint(path, device=device)
    if ctype.lower() == "cosyvoice":
        if os.path.isdir(path):
            flow, hift = os.path.join(path, "flow.pt"), os.path.join(path, "hift.pt")
        elif ":" in path:
            flow, hift = path.split(":", 1)
        else:
            raise FileNotFoundError(f"codec_decoder_path={path!r}: expected a directory holding flow.pt and "
                                    "hift.pt, or flow.pt:hift.pt")
        return CodecDecoder.from_cosyvoice_checkpoint(flow, hift, device=device)
    raise ValueError(f"unknown codec_decoder_type {ctype!r}: expected SNAC or CosyVoice")


class S2SSession:
    """The model (weights materialized on ``device``, then split over the
    mesh's tp axis and, with fsdp, sharded over its data ranks), its
    generator and codec; runs dialogue rounds. ``one_dialogue``: every rank
    serves the same rounds (the online modes), and only rank 0 writes."""

    def __init__(self, cfg: RunConfig, device="cuda", mesh=None, one_dialogue: bool = False):
        import torch.distributed as dist

        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh, self.tp = mesh, tp_of(mesh)
        self.sharded = mesh is not None and mesh["fsdp"].size() > 1
        # under a mesh on meta, then straight into this rank's shards: the tp
        # split, then FSDP2 over the data ranks when sharded
        model, tokenizer = build_model(cfg, self.device, mesh)
        materialize_params(model, cfg, mesh=mesh, device=self.device)
        if self.sharded:
            logger.info("sharded decode: fsdp=%d x tp=%d", mesh["fsdp"].size(), mesh["tp"].size())
        # prints, runs the codec, writes
        self.writer = (dist.get_rank() == 0) if one_dialogue and mesh is not None else (
            self.tp is None or self.tp.rank == 0)
        self.seed = cfg.train_config.seed
        self.model, self.tokenizer = model.eval(), tokenizer
        self.vocab = model.cfg.vocab
        dc = cfg.decode_config
        self.gen = S2SGenerator(
            model, max_new_tokens=dc.max_new_tokens, do_sample=dc.do_sample, temperature=dc.temperature,
            top_k=dc.top_k, text_repetition_penalty=getattr(dc, "text_repetition_penalty", dc.repetition_penalty),
            audio_repetition_penalty=getattr(dc, "audio_repetition_penalty", 1.0),
            num_latency_tokens=getattr(dc, "num_latency_tokens", 0),
            decode_text_only=getattr(dc, "decode_text_only", False), mesh=mesh if self.sharded else None,
        )
        self.codec = load_codec(cfg, self.device) if self.writer else None
        self.history = ""
        self.mel_size = getattr(cfg.dataset_config, "mel_size", 80)
        self.fix_length_audio = getattr(cfg.dataset_config, "fix_length_audio", -1)
        self.max_audio_s = getattr(cfg.dataset_config, "max_audio_length_s", 30.0)
        self.system_prompt = getattr(cfg.dataset_config, "prompt", None) or DEFAULT_S2S_PROMPT

    def sampler(self) -> torch.Generator:
        """A generation's sampling stream: seeded alike on every rank and for
        every generation (unused by greedy decoding)."""
        return torch.Generator(device=self.device).manual_seed(self.seed)

    def _text(self, ids) -> str:
        return self.tokenizer.decode([int(x) for x in ids if 0 <= int(x) < self.vocab.text_vocabsize]).strip()

    def _round_batch(self, wav_path, text_input, history=""):
        return build_round_batch(self.tokenizer, self.vocab, self.system_prompt, history=history,
                                 wav_path=wav_path, text_input=text_input, mel_size=self.mel_size,
                                 max_audio_s=self.max_audio_s, fix_length_audio=self.fix_length_audio)

    def run_round(self, wav_path: Optional[str] = None, text_input: Optional[str] = None,
                  keep_history: bool = False) -> Tuple[str, Optional[np.ndarray], np.ndarray]:
        """One round -> (text, waveform or None, the trimmed audio streams)."""
        batch = self._round_batch(wav_path, text_input, self.history if keep_history else "")
        trimmed = trim_generated(self.gen.generate(batch, generator=self.sampler())[0], self.vocab)
        text_out = self._text(trimmed[-1])
        # trim_generated cuts every audio layer at one end index
        streams = np.stack(trimmed[:-1]) if trimmed[0].size else np.zeros((self.vocab.code_layer, 0), np.int64)
        wav = self.codec.decode(streams) if self.codec is not None and streams.shape[1] > 8 else None
        if keep_history:
            user = text_input if text_input is not None else "<audio>"
            self.history = self.history + USER_TURN.format(user) + ASSISTANT_TURN.format(text_out)
        return text_out, wav, streams

    def stream_round(self, wav_path=None, text_input=None, stream_stride: int = 24
                     ) -> Iterator[Tuple[str, Optional[np.ndarray]]]:
        """Yield (text delta, waveform chunk or None) as the tokens decode.
        The text is decoded cumulatively: a chunk boundary can split a
        multi-byte character's tokens."""
        batch = self._round_batch(wav_path, text_input)
        acc_ids: List[int] = []
        prev = ""
        for chunk in self.gen.stream_generate(batch, generator=self.sampler(), stream_stride=stream_stride,
                                              codec_decoder=self.codec):
            acc_ids.extend(int(x) for x in chunk["text_tokens"][0] if 0 <= int(x) < self.vocab.text_vocabsize)
            full = self.tokenizer.decode(acc_ids)
            delta, prev = full[len(prev):], full
            yield delta, chunk.get("audio")


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def _lines(session: S2SSession, lines) -> Iterator[str]:
    """The input lines, read on rank 0 and broadcast to every rank (each
    tp and fsdp rank decodes each round); an empty line ends them."""
    import torch.distributed as dist

    source = iter(sys.stdin if lines is None else lines) if session.writer else None
    while True:
        line = [next(source, "").strip() if source is not None else None]
        if session.mesh is not None:
            dist.broadcast_object_list(line, src=0)
        if not line[0]:
            return
        yield line[0]


def run_online(session: S2SSession, cfg: RunConfig, multi_round: bool, stream: bool, lines=None) -> List[str]:
    """Rounds from ``lines`` (stdin by default) until an empty line: a wav
    path or ``t:<text>``; the wavs go to ``{decode_log}/round<i>.wav``.
    Returns the texts."""
    say = print if session.writer else (lambda *a, **k: None)
    out_dir = Path(getattr(cfg.decode_config, "decode_log", "/tmp/s2s_out"))
    out_dir.mkdir(parents=True, exist_ok=True)
    mode = "multi-round" if multi_round else ("streaming" if stream else "single")
    say(f"S2S online ({mode}). Enter: <wav_path>  or  t:<text>  (empty line exits)")
    texts = []
    for rnd, line in enumerate(_lines(session, lines)):
        wav_path, text_input = (None, line[2:]) if line.startswith("t:") else (line, None)
        if stream:
            pieces, wavs = [], []
            for text, wav in session.stream_round(wav_path, text_input,
                                                  stream_stride=getattr(cfg.decode_config, "stream_stride", 24)):
                say(text, end="", flush=True)
                pieces.append(text)
                if wav is not None:
                    wavs.append(wav)
            say()
            text, wav = "".join(pieces), np.concatenate(wavs) if wavs else None
        else:
            text, wav, _ = session.run_round(wav_path, text_input, keep_history=multi_round)
            say(f"ASSISTANT: {text}")
        if wav is not None:
            path = str(out_dir / f"round{rnd}.wav")
            write_wav(path, wav, session.codec.sample_rate)
            print(f"[audio -> {path}]")
        texts.append(text)
    return texts


def item_batch(item: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """An inference-mode dataset item -> a batch of one (no padding)."""
    t = item["input_ids"].shape[1]
    batch = {"input_ids": item["input_ids"][None], "attention_mask": np.ones((1, t), np.int32),
             "modality_mask": np.zeros((1, t), np.int32)}
    if item.get("audio_mel") is not None:
        batch["audio_mel"] = item["audio_mel"][None].astype(np.float32)
        batch["audio_mel_mask"] = np.ones((1, item["audio_mel"].shape[0]), np.int32)
        ms = item["modality_start"]
        batch["modality_mask"][0, ms: ms + item["audio_length"]] = 1
    return batch


def run_batch(session: S2SSession, cfg: RunConfig) -> Dict[str, Any]:
    """Manifest decode (the reference's generate_s2s_batch.py):
    ``{decode_log}_pred`` / ``_gt`` and a wav per utterance (this data
    rank's items, every ``n``-th from its rank, into ``_rank{r}`` logs when
    there are ``n`` > 1 data ranks). Returns the counts, the paths, per
    utterance its prefill / decode / codec times, decode steps and samples,
    and the RTF over the questions' audio (as much of each as the model
    hears: ``max_audio_length_s`` at most)."""
    cfg.dataset_config.inference_mode = True
    ds = get_custom_dataset_factory(cfg.dataset_config)(cfg.dataset_config, session.tokenizer, "test")
    ranks, rank = (1, 0) if session.mesh is None else (data_size(session.mesh), data_rank(session.mesh))
    # under fsdp every rank runs as many decodes (its gathers pair up): a
    # rank whose share ran out decodes a wrapped item and writes nothing
    rounds = -(-len(ds) // ranks) if session.sharded else None
    log = getattr(cfg.decode_config, "decode_log", "/tmp/s2s_decode")
    suffix = f"_rank{rank}" if ranks > 1 else ""
    pred, gt = (log + "_pred" + suffix, log + "_gt" + suffix) if session.writer else (os.devnull, os.devnull)
    wav_dir = Path(log + "_wav")
    if session.writer:
        wav_dir.mkdir(parents=True, exist_ok=True)
    utts, audio_s = [], 0.0
    t_all = time.perf_counter()
    with open(pred, "w") as fp, open(gt, "w") as fg:
        items = range(rank, len(ds), ranks) if rounds is None else range(rank, rounds * ranks, ranks)
        for i in items:
            if i >= len(ds):  # the wrapped item: its decode joins the others' steps
                session.gen.generate(item_batch(ds[i % len(ds)]), generator=session.sampler())
                continue
            item = ds[i]
            t = item["input_ids"].shape[1]
            batch = item_batch(item)
            audio_s += item["audio_seconds"]
            st0 = dict(session.gen.stats)
            trimmed = trim_generated(session.gen.generate(batch, generator=session.sampler())[0], session.vocab)
            st = {k: session.gen.stats[k] - st0[k] for k in st0}
            key = item.get("key", str(i))
            fp.write(f"{key}\t{session._text(trimmed[-1])}\n")
            fg.write(f"{key}\t{item.get('target_text') or ''}\n")
            codec_s, samples = 0.0, 0
            if session.codec is not None and trimmed[0].size > 8:
                t0 = time.perf_counter()
                wav = session.codec.decode(np.stack(trimmed[:-1]))
                codec_s = time.perf_counter() - t0
                samples = len(wav)
                write_wav(str(wav_dir / f"{key}.wav"), wav, session.codec.sample_rate)
            utts.append({"key": key, "prompt_len": t, "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
                         "decode_steps": st["decode_steps"], "useful_steps": st["useful_steps"],
                         "audio_frames": int(trimmed[0].size),
                         "codec_s": codec_s, "samples": samples})
    seconds = time.perf_counter() - t_all
    if session.writer:
        logger.info("wrote %s / %s (+ wavs in %s)", pred, gt, wav_dir)
    return {"n": len(utts), "pred": pred, "gt": gt, "wav_dir": str(wav_dir), "utterances": utts,
            "seconds": seconds, "audio_seconds": audio_s, "rtf": seconds / audio_s if audio_s else float("nan")}


def main(cfg: RunConfig, device="cuda"):
    """Build the session on ``device`` (on the ``(dp, fsdp, tp)`` mesh under
    torchrun) and run ``decode_config.mode``; returns ``run_batch``'s
    results or the online rounds' texts."""
    shard = cfg.train_config.shard
    mesh = None
    if maybe_init_distributed(device):
        mesh = make_mesh(dp=-1, fsdp=shard.fsdp, tp=shard.tp, device_type=resolve_device(device).type)
    elif shard.tp > 1 or shard.fsdp > 1:
        raise ValueError(f"shard.fsdp={shard.fsdp} x shard.tp={shard.tp} needs {shard.fsdp * shard.tp} processes "
                         "or more (torchrun); this is one")
    mode = getattr(cfg.decode_config, "mode", "online")
    if mode != "batch" and mesh is not None and mesh["dp"].size() > 1:
        raise NotImplementedError(
            f"generate_s2s {mode} decodes one dialogue: run it on the tp and fsdp ranks alone "
            f"(world = shard.fsdp x shard.tp), not on {mesh['dp'].size()} dp replicas")
    session = S2SSession(cfg, device, mesh, one_dialogue=mode != "batch")
    if mode == "batch":
        return run_batch(session, cfg)
    return run_online(session, cfg, multi_round="multi_round" in mode, stream="stream" in mode)


def main_cli(argv: Optional[List[str]] = None):
    argv, device = parse_device(list(sys.argv[1:] if argv is None else argv))
    try:
        return main(load_run_config(argv), device=device)
    finally:
        destroy_process_group()


if __name__ == "__main__":
    main_cli()
