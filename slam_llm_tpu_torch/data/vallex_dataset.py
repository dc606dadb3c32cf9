"""VALL-E X TTS jsonl dataset: phonemes and codec tokens, bucketed batches.

Counterpart of ``slam_llm_tpu/data/vallex_dataset.py``. Each row is
``{key, phonemes, audio_tokens}``: the phonemes are ids, or a string that
goes through the tokenizer (else ``ord`` of each character), folded into the
model's phoneme vocabulary (``dataset_config.text_vocabsize``, 512 when
unset); ``audio_tokens`` are (n_codebooks, T) EnCodec codes (one row is
repeated over the codebooks, missing rows are zeros). The collator pads text
and audio right to the ``text_buckets`` / ``audio_token_buckets`` tables and
draws each row's NAR stage in [1, n_codebooks) from one
``np.random.default_rng(dataset_config.seed)`` held for the dataset's life,
under a lock (the prefetch loader collates from threads), so the stages are
the JAX package's draw for draw.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List

import numpy as np

from slam_llm_tpu_torch.data.speech_dataset import bucketize, normalize_split


class VallexDatasetJsonl:
    def __init__(self, dataset_config, tokenizer=None, split: str = "train"):
        split = normalize_split(dataset_config, split)
        self.config = dataset_config
        self.tokenizer = tokenizer
        self.split = split
        self.n_codebooks = getattr(dataset_config, "code_layer", 8)
        tv = getattr(dataset_config, "text_vocabsize", -1)
        self.text_vocab = tv if tv and tv > 0 else 512  # VallexConfig's default
        self.seed = getattr(dataset_config, "seed", 0)
        self._rng = np.random.default_rng(self.seed)
        self._rng_lock = threading.Lock()
        path = dataset_config.train_data_path if split == "train" else dataset_config.val_data_path
        with open(path, encoding="utf-8") as f:
            self.data_list = [json.loads(line) for line in f if line.strip()]

    def __len__(self) -> int:
        return len(self.data_list)

    def _phoneme_ids(self, item) -> np.ndarray:
        ph = item["phonemes"]
        if isinstance(ph, str):
            if self.tokenizer is not None:
                ids = np.asarray(self.tokenizer.encode(ph), np.int64)
            else:
                ids = np.asarray([ord(c) for c in ph], np.int64)
            return ids % self.text_vocab
        return np.asarray(ph, np.int64) % self.text_vocab

    def __getitem__(self, index: int) -> Dict[str, Any]:
        item = self.data_list[index]
        audio = np.asarray(item["audio_tokens"], np.int64)
        if audio.ndim == 1:
            audio = audio[None].repeat(self.n_codebooks, 0)
        if audio.shape[0] < self.n_codebooks:
            pad = np.zeros((self.n_codebooks - audio.shape[0], audio.shape[1]), np.int64)
            audio = np.concatenate([audio, pad], axis=0)
        return {"key": item.get("key", str(index)), "text_ids": self._phoneme_ids(item),
                "audio_ids": audio[: self.n_codebooks]}

    def sort_key(self, index: int) -> int:
        a = self.data_list[index].get("audio_tokens", [])
        return len(a[0]) if a and isinstance(a[0], list) else len(a)

    def _draw_nar_stage(self, b: int, n_codebooks: int) -> np.ndarray:
        if n_codebooks <= 1:
            return np.ones((b,), np.int32)  # one codebook: no NAR stage
        with self._rng_lock:
            return self._rng.integers(1, n_codebooks, size=b).astype(np.int32)

    def collator(self, samples: List[Dict[str, Any]]) -> Dict[str, Any]:
        text_buckets = list(getattr(self.config, "text_buckets", [32, 64, 128, 256]))
        audio_buckets = list(getattr(self.config, "audio_token_buckets", [128, 256, 512, 1024]))
        b, n_cb = len(samples), self.n_codebooks
        tt = bucketize(max(len(s["text_ids"]) for s in samples), text_buckets)
        ta = bucketize(max(s["audio_ids"].shape[1] for s in samples), audio_buckets)
        text_ids = np.zeros((b, tt), np.int64)
        text_mask = np.zeros((b, tt), np.int32)
        audio_ids = np.zeros((b, n_cb, ta), np.int64)
        audio_mask = np.zeros((b, ta), np.int32)
        for i, s in enumerate(samples):
            nt, na = len(s["text_ids"]), s["audio_ids"].shape[1]
            text_ids[i, :nt] = s["text_ids"]
            text_mask[i, :nt] = 1
            audio_ids[i, :, :na] = s["audio_ids"]
            audio_mask[i, :na] = 1
        return {"text_ids": text_ids, "text_mask": text_mask, "audio_ids": audio_ids, "audio_mask": audio_mask,
                "nar_stage": self._draw_nar_stage(b, n_cb), "keys": [s["key"] for s in samples]}


def get_vallex_dataset(dataset_config, tokenizer, split: str) -> VallexDatasetJsonl:
    return VallexDatasetJsonl(dataset_config, tokenizer, split)
