"""VALL-E X zero-shot TTS: AR -> NAR -> EnCodec decode -> wav.

Counterpart of ``slam_llm_tpu/pipeline/inference_vallex.py`` with the same
flags plus ``--device`` (default ``cuda``; asking for CUDA without a GPU
raises). Given an enrolled acoustic prompt (its EnCodec codes and
transcript) and a target text: codebook 0 is sampled autoregressively
(top-k, a ``torch.Generator`` seeded by ``--seed``), codebooks 1.. are
filled by the NAR stack, the prompt's frames are stripped, the codes are
clamped to the codec's codebook and decoded by the port's EnCodec
(``models/encodec.py``), and the wav is written with the stdlib ``wave``:

    python -m slam_llm_tpu_torch.pipeline.inference_vallex \\
        --ckpt_path out/vallex_tts_epoch_1_step_10 --llm_name vallex \\
        --codec_path encodec_24khz/model.safetensors \\
        --prompt_text "..." --prompt_codes prompt.npy \\
        --target_text "..." --save_path out.wav

``--ckpt_path`` is what ``pipeline.finetune`` writes (a checkpoint
directory or its ``model.pt``), or the JAX package's ``model.msgpack``;
it must hold every VALLE tensor. Prompt codes are ``(n_q, T)`` ``.npy`` /
``.json`` arrays. ``main`` returns the wav's path, its frames and samples,
and the seconds of the AR (and its steps), the NAR and the codec.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import wave
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from slam_llm_tpu_torch.models.encodec import EncodecConfig, encodec_decode, load_encodec_checkpoint
from slam_llm_tpu_torch.models.vallex import PRESETS, VALLE
from slam_llm_tpu_torch.ops.torch_port import to_device
from slam_llm_tpu_torch.pipeline.common import parse_device, resolve_device


def write_wav(path: str, wav: np.ndarray, sample_rate: int = 24000) -> None:
    pcm16 = (np.clip(np.asarray(wav, np.float32), -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm16.tobytes())


def text_to_ids(text, tokenizer, text_vocab: int) -> np.ndarray:
    """The dataset's fallback: ids as given, else the tokenizer's (``ord``
    of each character if it fails or there is none), folded into the
    model's phoneme vocabulary."""
    if isinstance(text, (list, np.ndarray)):
        ids = np.asarray(text, np.int64)
    elif tokenizer is not None:
        try:
            ids = np.asarray(tokenizer.encode(text), np.int64)
        except Exception:
            ids = np.asarray([ord(c) for c in text], np.int64)
    else:
        ids = np.asarray([ord(c) for c in text], np.int64)
    return ids % text_vocab


def load_codes(path: str) -> np.ndarray:
    """(n_q, T) int prompt codes from ``.npy`` / ``.json``."""
    if path.endswith(".npy"):
        codes = np.load(path)
    else:
        with open(path, encoding="utf-8") as f:
            codes = np.asarray(json.load(f))
    codes = np.asarray(codes, np.int64)
    return codes[None] if codes.ndim == 1 else codes


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def synthesize(model: VALLE, prompt_text_ids: np.ndarray, target_text_ids: np.ndarray, prompt_codes: np.ndarray, *,
               max_new: int = 600, top_k: int = 50, temperature: float = 1.0,
               generator: Optional[torch.Generator] = None, stats: Optional[Dict] = None) -> Tuple[np.ndarray, int]:
    """AR (codebook 0), then NAR (codebooks 1..), for one utterance. Returns
    the generated region's codes ``(n_codebooks, T_gen)`` (the prompt's
    frames stripped) and ``T_gen``; the enrolled prompt keeps its true codes
    in every codebook, and generation stops at end-of-audio. ``stats``, if
    given, gets ``ar_s``, ``ar_steps`` and ``nar_s`` (host clock around
    synchronised work)."""
    c = model.cfg
    dev = next(model.parameters()).device
    n_q = min(prompt_codes.shape[0], c.n_codebooks)
    prompt_codes = prompt_codes[:n_q]
    tp = prompt_codes.shape[1]
    text_ids = torch.as_tensor(np.concatenate([prompt_text_ids, target_text_ids])[None], device=dev)
    text_mask = torch.ones_like(text_ids, dtype=torch.int32)
    t0 = time.perf_counter()
    audio0 = model.infer_ar(text_ids, text_mask, torch.as_tensor(prompt_codes[0][None], device=dev),
                            torch.tensor([tp], device=dev), max_new, generator, top_k, temperature)
    a0 = audio0[0].cpu().numpy()
    gen = a0[tp:]
    hits = np.nonzero(gen == c.eos_audio)[0]
    t_gen = int(hits[0]) if hits.size else len(gen)
    if stats is not None:
        stats.update(ar_s=time.perf_counter() - t0, ar_steps=min(max_new, t_gen + 1), nar_s=0.0)
    if t_gen == 0:
        return np.zeros((c.n_codebooks, 0), np.int64), 0
    t_total = tp + t_gen
    audio_ids = np.zeros((1, c.n_codebooks, t_total), np.int64)
    audio_ids[0, 0] = a0[:t_total]
    audio_ids[0, :n_q, :tp] = prompt_codes
    t0 = time.perf_counter()
    out = model.infer_nar(text_ids, text_mask, torch.as_tensor(audio_ids, device=dev),
                          torch.ones((1, t_total), dtype=torch.int32, device=dev), torch.tensor([tp], device=dev))
    codes = out[0, :, tp:t_total].cpu().numpy()
    if stats is not None:
        stats["nar_s"] = time.perf_counter() - t0
    return codes, t_gen


def load_vallex(ckpt_path: str, llm_name: str, device) -> VALLE:
    """VALLE of preset ``llm_name`` on ``device`` with every tensor from the
    checkpoint (``utils.checkpoint.load_trainable``: ``model.pt`` or a JAX
    ``model.msgpack``)."""
    from slam_llm_tpu_torch.utils.checkpoint import load_trainable

    model = VALLE(PRESETS[llm_name](), device=device)
    saved = load_trainable(ckpt_path)
    missing = sorted(set(model.state_dict()) - set(saved))
    if missing:
        raise KeyError(f"{ckpt_path} lacks {len(missing)} VALLE tensors, e.g. {missing[:3]}")
    model.load_state_dict(saved)
    return model.eval()


def main(argv: Optional[List[str]] = None) -> Dict:
    argv, device = parse_device(list(sys.argv[1:] if argv is None else argv))
    ap = argparse.ArgumentParser(description="VALL-E X TTS inference")
    ap.add_argument("--ckpt_path", required=True, help="trained VALLE tensors (pipeline.finetune's checkpoint)")
    ap.add_argument("--llm_name", default="vallex", help="vallex | vallex-tiny-test")
    ap.add_argument("--codec_path", required=True, help="EnCodec decoder (.safetensors / .bin / .msgpack)")
    ap.add_argument("--prompt_text", required=True)
    ap.add_argument("--prompt_codes", required=True, help="(n_q, T) EnCodec codes of the prompt (.npy / .json)")
    ap.add_argument("--target_text", required=True)
    ap.add_argument("--save_path", required=True)
    ap.add_argument("--llm_path", default=None, help="tokenizer directory (optional)")
    ap.add_argument("--top_k", type=int, default=50)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--max_new", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from slam_llm_tpu_torch.data.tokenizer import load_tokenizer

    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            "inference_vallex runs one process on a whole model, as the JAX package's does (ROADMAP, Do not port: "
            "a multi-rank inference_vallex)")
    dev = resolve_device(device)
    model = load_vallex(args.ckpt_path, args.llm_name, dev)
    cfg = model.cfg
    tokenizer = load_tokenizer(args.llm_path) if args.llm_path else None
    enc_cfg = EncodecConfig.tiny_test() if args.llm_name == "vallex-tiny-test" else EncodecConfig.encodec_24khz()
    enc_params = to_device(load_encodec_checkpoint(args.codec_path, enc_cfg), dev)

    stats: Dict = {}
    codes, t_gen = synthesize(
        model, text_to_ids(args.prompt_text, tokenizer, cfg.text_vocab),
        text_to_ids(args.target_text, tokenizer, cfg.text_vocab), load_codes(args.prompt_codes),
        max_new=args.max_new, top_k=args.top_k, temperature=args.temperature,
        generator=torch.Generator(device=dev).manual_seed(args.seed), stats=stats,
    )
    if t_gen == 0:
        raise SystemExit("model emitted end-of-audio immediately; nothing to decode")
    # the end-of-audio and pad ids of audio_vocab_padded are not codec codes
    codes = np.clip(codes, 0, enc_cfg.codebook_size - 1)
    t0 = time.perf_counter()
    wav = encodec_decode(enc_params, codes[None], enc_cfg)[0]
    _sync(dev)
    stats["codec_s"] = time.perf_counter() - t0
    write_wav(args.save_path, wav, enc_cfg.sampling_rate)
    print(f"wrote {args.save_path}: {t_gen} frames, {wav.shape[0]} samples @ {enc_cfg.sampling_rate} Hz "
          f"(AR {stats['ar_s']:.3f} s over {stats['ar_steps']} steps, NAR {stats['nar_s']:.3f} s, "
          f"codec {stats['codec_s']:.3f} s)")
    return {"path": args.save_path, "frames": t_gen, "samples": int(wav.shape[0]),
            "audio_seconds": wav.shape[0] / enc_cfg.sampling_rate, **stats}


if __name__ == "__main__":
    main()
