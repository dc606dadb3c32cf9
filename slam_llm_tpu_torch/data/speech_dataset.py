"""Speech jsonl dataset with static-shape bucketed collation.

Token-assembly semantics are kept identical to the reference
(``datasets/speech_dataset.py:86-161``):

  sample  = [audio_pseudo(-1) x audio_length, prompt_ids, answer_ids, eos]
  labels  = [-100 over audio+prompt, answer_ids, eos]
  collate = LEFT-pad the (audio+prompt) segment, RIGHT-pad the answer segment
            (reference :216-291), emitting ``modality_mask`` marking the
            audio pseudo-token span.

Counterpart of ``slam_llm_tpu/data/speech_dataset.py``. Padded lengths are rounded up to a bucket table instead
of the per-batch max, so every batch shape comes from a small finite set and
XLA compiles each bucket once (SURVEY.md §7.1 / §7.3 item 1). For
``input_type=mel`` the mel is padded/trimmed to 30 s exactly like whisper
(the reference's ``whisper.pad_or_trim``), so audio_length is the constant
300 (= 3000 mel //2 //5) and only the text dimension buckets.
"""

from __future__ import annotations

import bisect
import json
import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from slam_llm_tpu_torch.ops import audio as audio_ops

IGNORE_INDEX = -100
DEFAULT_PROMPT = (
    "Transcribe speech to text. Output the transcription directly without "
    "redundant content. Ensure that the output is not duplicated. "
)
PROMPT_TEMPLATE = "USER: {}\n ASSISTANT:"


def normalize_split(dataset_config, split: str) -> str:
    """Map a configured ``train_split`` alias (e.g. 'train_960') to the
    literal 'train' that the in-tree datasets branch on — otherwise a custom
    alias would silently select val_data_path for training."""
    if split == "train" or split == getattr(dataset_config, "train_split", "train"):
        return "train"
    return split


def bucketize(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; extends by doubling the last bucket if needed."""
    buckets = sorted(buckets)
    i = bisect.bisect_left(buckets, n)
    if i < len(buckets):
        return buckets[i]
    b = buckets[-1]
    while b < n:
        b *= 2
    return b


def read_jsonl(path: str) -> List[dict]:
    with open(path, encoding="utf-8") as fin:
        return [json.loads(line) for line in (raw.strip() for raw in fin) if line]


class SpeechDatasetJsonl:
    """Map-style dataset over a ``{key, source, target}`` jsonl manifest."""

    def __init__(self, dataset_config, tokenizer=None, split: str = "train"):
        split = normalize_split(dataset_config, split)
        self.config = dataset_config
        self.tokenizer = tokenizer
        self.split = split
        self.prompt = getattr(dataset_config, "prompt", None) or DEFAULT_PROMPT
        self.mel_size = getattr(dataset_config, "mel_size", 80)
        self.fix_length_audio = getattr(dataset_config, "fix_length_audio", -1)
        self.inference_mode = getattr(dataset_config, "inference_mode", False)
        self.normalize = getattr(dataset_config, "normalize", False)
        self.input_type = getattr(dataset_config, "input_type", "mel")
        assert self.input_type in ("raw", "mel")
        self.max_audio_samples = int(
            getattr(dataset_config, "max_audio_length_s", 30.0) * audio_ops.SAMPLE_RATE
        )
        self.specaug = bool(getattr(dataset_config, "specaug", False)) and split == "train"
        self._specaug_rng = np.random.default_rng(1234)
        import threading

        self._specaug_lock = threading.Lock()

        self.data_list: List[dict] = self.read_manifest(dataset_config, split)

    def read_manifest(self, dataset_config, split: str) -> List[dict]:
        """The split's items: the jsonl of ``train_data_path`` or
        ``val_data_path`` (the datasets built on this one read their own)."""
        return read_jsonl(dataset_config.train_data_path if split == "train" else dataset_config.val_data_path)

    def __len__(self):
        return len(self.data_list)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        item = self.data_list[index]
        audio_path = item.get("source")
        target = item.get("target")
        key = item.get("key")

        audio_raw = audio_ops.load_audio(audio_path)
        # true duration BEFORE pad_or_trim (RTF accounting; the 30 s-padded
        # mel mask would overstate audio seconds ~4x on short utterances)
        audio_seconds = len(audio_raw) / audio_ops.SAMPLE_RATE
        audio_mel = None
        if self.input_type == "raw":
            if self.normalize:
                mu, sd = audio_raw.mean(), audio_raw.std()
                audio_raw = (audio_raw - mu) / np.sqrt(sd * sd + 1e-5)
            # fairseq conv frontend 320x downsample, then 5x projector stack
            # (reference speech_dataset.py:98-100)
            audio_length = len(audio_raw) // 320 // 5
        else:
            audio_raw = audio_ops.pad_or_trim(audio_raw, self.max_audio_samples)
            audio_mel = audio_ops.log_mel_spectrogram(audio_raw, n_mels=self.mel_size)
            if self.specaug:
                from slam_llm_tpu_torch.ops.specaug import spec_augment

                # np.random.Generator is NOT thread-safe and PrefetchLoader
                # collates from a thread pool: draw a child seed under a
                # lock, augment with a private generator
                with self._specaug_lock:
                    child = int(self._specaug_rng.integers(2**63))
                audio_mel = spec_augment(audio_mel, rng=np.random.default_rng(child))
            # (T+1)//2 whisper conv downsample, then //5 projector stack
            # (reference speech_dataset.py:104-105)
            audio_length = (audio_mel.shape[0] + 1) // 2 // 5
        if self.fix_length_audio > 0:
            audio_length = self.fix_length_audio

        # per-utterance keyword biasing (mala_asr / contextual_asr manifests
        # carry a ``hotwords`` list; reference folds OCR/CTC-filtered words
        # into the prompt)
        prompt = self.prompt
        hotwords = item.get("hotwords")
        if hotwords:
            words = " ".join(hotwords) if isinstance(hotwords, (list, tuple)) else str(hotwords)
            prompt = f"{prompt} Use these possible keywords: {words}."
        # DRCap RAG: retrieved similar captions folded into the prompt
        # (reference examples/drcap_zeroshot_aac dataset rag path)
        sims = item.get("similar_captions")
        if sims:
            joined = "; ".join(str(s) for s in sims)
            prompt = f"{prompt} Similar captions for reference: {joined}."

        prompt_ids = self.tokenizer.encode(PROMPT_TEMPLATE.format(prompt))
        prompt_length = len(prompt_ids)
        audio_pseudo = np.full((audio_length,), -1, dtype=np.int64)

        if self.inference_mode:
            input_ids = np.concatenate([audio_pseudo, np.asarray(prompt_ids, np.int64)])
            return {
                "input_ids": input_ids,
                "attention_mask": np.ones_like(input_ids, dtype=np.int32),
                "audio": audio_raw if self.input_type == "raw" else None,
                "audio_mel": audio_mel,
                "audio_length": audio_length,
                "audio_seconds": audio_seconds,
                "prompt_length": prompt_length,
                "key": key,
                "target": target,
            }

        example_ids = self.tokenizer.encode(PROMPT_TEMPLATE.format(prompt) + str(target))
        example_ids = list(example_ids) + [self.tokenizer.eos_token_id]
        example_ids = np.concatenate([audio_pseudo, np.asarray(example_ids, np.int64)])
        labels = example_ids.copy()
        labels[: audio_length + prompt_length] = IGNORE_INDEX
        input_ids = example_ids.copy()
        input_ids[input_ids == -1] = 0  # audio pseudo -> 0 (embeds overwritten)
        return {
            "input_ids": input_ids,
            "labels": labels,
            "attention_mask": np.ones_like(input_ids, dtype=np.int32),
            "audio": audio_raw if self.input_type == "raw" else None,
            "audio_mel": audio_mel,
            "audio_length": audio_length,
            "audio_seconds": audio_seconds,
            "prompt_length": prompt_length,
            "key": key,
            "target": target,
        }

    # ---- collation -------------------------------------------------------

    def collate_text(self, samples: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Text half of collation: left-pad prompt / right-pad answer to
        bucketed static shapes. Subclasses with non-mel/raw audio payloads
        (the JAX package's binaural SELD dataset) reuse this and attach their own."""
        cfg = self.config
        text_buckets = list(getattr(cfg, "text_buckets", [64, 128, 192, 256]))
        pad_id = self.tokenizer.pad_token_id

        prompt_lens = [s["audio_length"] + s["prompt_length"] for s in samples]
        answer_lens = [len(s["input_ids"]) - p for s, p in zip(samples, prompt_lens)]
        max_prompt = max(prompt_lens)
        max_answer = max(answer_lens)
        total = bucketize(max_prompt + max_answer, text_buckets)

        b = len(samples)
        input_ids = np.full((b, total), pad_id, dtype=np.int64)
        attention_mask = np.zeros((b, total), dtype=np.int32)
        labels = np.full((b, total), IGNORE_INDEX, dtype=np.int64)
        modality_mask = np.zeros((b, total), dtype=np.int32)

        for i, s in enumerate(samples):
            left = max_prompt - prompt_lens[i]
            n = len(s["input_ids"])
            input_ids[i, left : left + n] = s["input_ids"]
            attention_mask[i, left : left + n] = 1
            if "labels" in s:
                labels[i, left : left + n] = s["labels"]
            modality_mask[i, left : left + s["audio_length"]] = 1

        out: Dict[str, Any] = {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "modality_mask": modality_mask,
        }
        if not self.inference_mode:
            out["labels"] = labels
        else:
            out["keys"] = [s["key"] for s in samples]
            out["targets"] = [s["target"] for s in samples]
        if any("audio_seconds" in s for s in samples):
            out["audio_seconds"] = float(
                sum(s.get("audio_seconds", 0.0) for s in samples)
            )
        return out

    def collator(self, samples: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Full collation: text buckets + the mel/raw audio payload."""
        cfg = self.config
        audio_buckets = list(
            getattr(cfg, "audio_buckets", [48000, 96000, 160000, 240000, 480000])
        )
        out = self.collate_text(samples)
        b = len(samples)

        if self.input_type == "mel":
            mel_len = max(s["audio_mel"].shape[0] for s in samples)
            n_mels = samples[0]["audio_mel"].shape[1]
            audio_mel = np.zeros((b, mel_len, n_mels), dtype=np.float32)
            audio_mel_mask = np.zeros((b, mel_len), dtype=np.int32)
            for i, s in enumerate(samples):
                m = s["audio_mel"]
                audio_mel[i, : m.shape[0]] = m
                audio_mel_mask[i, : m.shape[0]] = 1
            out["audio_mel"] = audio_mel
            out["audio_mel_mask"] = audio_mel_mask
        else:
            alen = bucketize(max(len(s["audio"]) for s in samples), audio_buckets)
            audio = np.zeros((b, alen), dtype=np.float32)
            audio_mask = np.zeros((b, alen), dtype=np.int32)
            for i, s in enumerate(samples):
                audio[i, : len(s["audio"])] = s["audio"]
                audio_mask[i, : len(s["audio"])] = 1
            out["audio"] = audio
            out["audio_mask"] = audio_mask
        return out

    def sort_key(self, index: int) -> int:
        """Length proxy for the length-grouped sampler."""
        item = self.data_list[index]
        if "source_len" in item:
            return int(item["source_len"])
        return len(str(item.get("target", "")))


def get_speech_dataset(dataset_config, tokenizer, split: str) -> SpeechDatasetJsonl:
    """Factory mirroring reference datasets/speech_dataset.py:295."""
    return SpeechDatasetJsonl(dataset_config, tokenizer, split)
