"""CLAP-Refine: rerank a decode's caption candidates by CLAP audio-text similarity.

Counterpart of ``slam_llm_tpu/utils/clap_refine.py`` (the reference's
``examples/slam_aac/utils/clap_refine.py``). The candidates are the lines of
one or more decode logs (``key<TAB>text``): a beam decode with
``num_return_sequences = N`` writes N lines a key, and several logs (one
per beam width) add theirs. Each key keeps the candidate whose text
embedding is most similar to its audio's.

``clap_refine_with_model`` runs the whole rerank with an HTSAT + BERT CLAP
checkpoint: the mel of each clip is the port's ``ops.audio`` log-mel (64
bins), zero-padded to HTSAT's ``spec_size * freq_ratio`` frames; the captions
are tokenized by ``utils.fense.WordPieceTokenizer`` over a ``vocab.txt``.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


def read_candidates(paths: Sequence[str]) -> Dict[str, List[str]]:
    """Decode logs (key<TAB>text) -> {key: [candidate, ...]} in file order."""
    cands: Dict[str, List[str]] = {}
    for p in paths:
        with open(p, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t", 1)
                if not parts or not parts[0]:
                    continue
                cands.setdefault(parts[0], []).append(parts[1] if len(parts) > 1 else "")
    return cands


def clap_refine(
    candidates: Dict[str, List[str]],
    audio_embed_fn: Callable[[str], np.ndarray],  # key -> (D,) normalized
    text_embed_fn: Callable[[List[str]], np.ndarray],  # texts -> (N, D) normalized
) -> Dict[str, str]:
    """The most similar candidate of each key (the first among equals)."""
    out = {}
    for key, texts in candidates.items():
        za = np.asarray(audio_embed_fn(key)).reshape(-1)
        sims = np.asarray(text_embed_fn(texts)) @ za
        out[key] = texts[int(np.argmax(sims))]
    return out


def write_selection(selection: Dict[str, str], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for key, text in selection.items():
            f.write(f"{key}\t{text}\n")


def clip_mel(path: str, cfg) -> np.ndarray:
    """(spec_size * freq_ratio, n_mels) f32 log-mel of one clip, zero-padded
    or cut to HTSAT's target length (``cfg``: a ``CLAPConfig``)."""
    from slam_llm_tpu_torch.ops import audio as audio_ops

    target_t = cfg.htsat.spec_size * cfg.htsat.freq_ratio
    mel = audio_ops.log_mel_spectrogram(audio_ops.load_audio(path), n_mels=cfg.htsat.n_mels)
    if mel.shape[0] < target_t:
        mel = np.pad(mel, ((0, target_t - mel.shape[0]), (0, 0)))
    return mel[:target_t].astype(np.float32)


def read_manifest(path: str) -> Dict[str, str]:
    """A decode-split jsonl -> {key: source}."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                row = json.loads(line)
                out[row["key"]] = row["source"]
    return out


def clap_refine_with_model(
    pred_logs: Sequence[str],
    clap_ckpt: str,
    audio_manifest: str,
    out: str,
    tokenizer_path: Optional[str] = None,
    max_text_len: int = 64,
    cfg=None,
    device="cuda",
) -> Dict[str, str]:
    """Load an ASE checkpoint (``models.clap.load_clap``) on ``device``, embed
    each key's clip and every candidate, write the most similar candidate
    of each key to ``out`` and return the selection. ``audio_manifest`` is
    the decode split's jsonl ({key, source, ...}); ``tokenizer_path`` a
    ``vocab.txt`` or the directory holding it (default: the checkpoint's
    directory); ``cfg`` a ``CLAPConfig`` (default: HTSAT-base + BERT-base,
    1024 wide). Keys missing from the manifest are skipped and reported."""
    from slam_llm_tpu_torch.models.clap import CLAPConfig, embed_texts, load_clap
    from slam_llm_tpu_torch.pipeline.common import resolve_device
    from slam_llm_tpu_torch.utils.fense import WordPieceTokenizer

    cfg = cfg or CLAPConfig()
    dev = resolve_device(device)
    model = load_clap(clap_ckpt, cfg, dev)
    vocab = tokenizer_path or os.path.dirname(os.path.abspath(clap_ckpt))
    tok = WordPieceTokenizer(os.path.join(vocab, "vocab.txt") if os.path.isdir(vocab) else vocab)
    wav_by_key = read_manifest(audio_manifest)

    @torch.inference_mode()
    def audio_embed_fn(key):
        mel = torch.from_numpy(clip_mel(wav_by_key[key], cfg))[None].to(dev)
        return model.encode_audio(mel)[0].cpu().numpy()

    cands = read_candidates(pred_logs)
    missing = [k for k in cands if k not in wav_by_key]
    if missing:
        print(f"clap_refine: skipping {len(missing)} keys missing from the manifest (e.g. {missing[0]!r})",
              file=sys.stderr)
        cands = {k: v for k, v in cands.items() if k in wav_by_key}
    sel = clap_refine(cands, audio_embed_fn, lambda texts: embed_texts(model, tok, texts, max_text_len))
    write_selection(sel, out)
    return sel
