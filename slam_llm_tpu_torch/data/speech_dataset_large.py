"""Large-scale multitask iterable dataset with token-budget bucket batching.

Counterpart of ``slam_llm_tpu/data/speech_dataset_large.py`` (the
reference's 100k-hour pipeline, ``datasets/speech_dataset_large.py``):

* an iterable over a ``multitask.jsonl`` manifest (rows ``{key, path, task,
  target, ...}``), sharded round-robin by rank;
* audio from wav files or Kaldi arks (``data.kaldi_ark``; a wav-ark entry's
  int16 samples / 32768);
* per-task prompt pools from ``multiprompt.jsonl`` (rows ``{task,
  prompt}``), drawn with ``random.Random(seed + rank)``, a pool's ``{}``
  filled with the row's field of the task's name for ``append_info_tasks``;
* utterances longer than ``max_audio_length_s`` skipped; raw audio
  (normalized on request, ``len // 320 // 5`` audio slots) or the whisper
  log-mel, not padded to 30 s unless ``pad_or_trim`` (``(mel + 1) // 2 // 5``
  slots);
* ``TokenBudgetBatcher``: each utterance goes to the smallest text bucket
  that holds its ``input_ids``, and a bucket emits a batch of ``budget //
  bucket`` utterances when it fills (the rest at the end), so every batch
  has one of a few shapes.

The batcher is iterable and has no ``len``: ``data.loader.build_dataloader``
takes map-style datasets only, so ``pipeline.finetune`` and
``pipeline.inference_batch`` refuse this dataset with a ``TypeError``, as
the JAX package's do. Drive it through the trainer's step and the
``Generator``.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import random
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from slam_llm_tpu_torch.data.speech_dataset import IGNORE_INDEX, SpeechDatasetJsonl, bucketize, normalize_split
from slam_llm_tpu_torch.ops import audio as audio_ops

PROMPT_TEMPLATE = "USER: {}\n ASSISTANT:"
DEFAULT_TASK_PROMPT = "Transcribe speech to text. "
logger = logging.getLogger(__name__)


class MultiTaskDataset:
    """Iterable over the manifest's utterances -> per-utterance dicts, the
    items of ``SpeechDatasetJsonl``."""

    def __init__(self, dataset_config, tokenizer=None, split: str = "train", rank: int = 0, world_size: int = 1):
        split = normalize_split(dataset_config, split)
        self.config = dataset_config
        self.tokenizer = tokenizer
        self.split = split
        self.rank, self.world_size = rank, world_size
        self.input_type = getattr(dataset_config, "input_type", "mel")
        self.mel_size = getattr(dataset_config, "mel_size", 80)
        self.normalize = getattr(dataset_config, "normalize", False)
        self.fix_length_audio = getattr(dataset_config, "fix_length_audio", -1)
        self.inference_mode = getattr(dataset_config, "inference_mode", False)
        self.max_audio_length = getattr(dataset_config, "max_audio_length_s", 30.0)
        self.pad_or_trim = getattr(dataset_config, "pad_or_trim", False)
        self.seed = getattr(dataset_config, "seed", 42)

        data_path = dataset_config.train_data_path if split == "train" else dataset_config.val_data_path
        if os.path.isdir(data_path):
            self.manifest = os.path.join(data_path, "multitask.jsonl")
            prompt_path = os.path.join(data_path, "multiprompt.jsonl")
        else:
            self.manifest = data_path
            prompt_path = os.path.join(os.path.dirname(data_path), "multiprompt.jsonl")
        self.prompts: Dict[str, List[str]] = {}
        if os.path.exists(prompt_path):
            with open(prompt_path, encoding="utf-8") as f:
                for line in f:
                    if line.strip():
                        row = json.loads(line)
                        self.prompts.setdefault(row["task"], []).append(row["prompt"])
        self.append_info_tasks = set(getattr(dataset_config, "append_info_tasks", ["hotword"]))

    def _load_audio(self, item: dict) -> np.ndarray:
        path = item.get("path") or item.get("source")
        if ".ark" in str(path):
            from slam_llm_tpu_torch.data.kaldi_ark import load_mat

            arr = load_mat(path)
            if isinstance(arr, tuple):  # (sample_rate, int16 waveform) of a wav-ark entry
                arr = arr[1]
            return np.asarray(arr, np.float32) / 32768.0
        return audio_ops.load_audio(path)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        rng = random.Random(self.seed + self.rank)
        with open(self.manifest, encoding="utf-8") as f:
            for idx, line in enumerate(f):
                if idx % self.world_size != self.rank or not line.strip():
                    continue
                item = json.loads(line)
                try:
                    audio_raw = self._load_audio(item)
                except Exception as e:  # an unreadable utterance is skipped, as in the reference
                    logger.warning("skipping %s: %s", item.get("key"), e)
                    continue
                if len(audio_raw) / audio_ops.SAMPLE_RATE > self.max_audio_length:
                    continue
                yield self._item(item, audio_raw, rng)

    def _item(self, item: dict, audio_raw: np.ndarray, rng: random.Random) -> Dict[str, Any]:
        audio_mel = None
        if self.input_type == "raw":
            if self.normalize:
                mu, sd = audio_raw.mean(), audio_raw.std()
                audio_raw = (audio_raw - mu) / np.sqrt(sd * sd + 1e-5)
            audio_length = len(audio_raw) // 320 // 5
        else:
            if self.pad_or_trim:
                audio_raw = audio_ops.pad_or_trim(audio_raw)
            audio_mel = audio_ops.log_mel_spectrogram(audio_raw, n_mels=self.mel_size)
            audio_length = (audio_mel.shape[0] + 1) // 2 // 5
        if self.fix_length_audio > 0:
            audio_length = self.fix_length_audio

        task = item.get("task", "asr")
        prompt = rng.choice(self.prompts.get(task, [DEFAULT_TASK_PROMPT]))
        if task in self.append_info_tasks and task in item:
            prompt = prompt.format(item[task])
        prompt_ids = self.tokenizer.encode(PROMPT_TEMPLATE.format(prompt))
        audio_pseudo = np.full((audio_length,), -1, np.int64)
        out = {"audio": audio_raw if self.input_type == "raw" else None, "audio_mel": audio_mel,
               "audio_length": audio_length, "prompt_length": len(prompt_ids), "key": item.get("key"),
               "target": item.get("target", "")}
        if self.inference_mode:
            # pseudo ids stay -1: the model clamps them, the repetition penalty skips them
            input_ids = np.concatenate([audio_pseudo, np.asarray(prompt_ids, np.int64)])
            return {"input_ids": input_ids, "attention_mask": np.ones_like(input_ids, np.int32), **out}
        example = list(self.tokenizer.encode(PROMPT_TEMPLATE.format(prompt) + str(out["target"])))
        example_ids = np.concatenate([audio_pseudo, np.asarray(example + [self.tokenizer.eos_token_id], np.int64)])
        labels = example_ids.copy()
        labels[: audio_length + len(prompt_ids)] = IGNORE_INDEX
        input_ids = example_ids.copy()
        input_ids[input_ids == -1] = 0
        return {"input_ids": input_ids, "labels": labels, "attention_mask": np.ones_like(input_ids, np.int32), **out}


class TokenBudgetBatcher:
    """Length buckets in place of the reference's greedy dynamic batching:
    a bucket emits ``budget // bucket`` utterances at a time, padded to the
    bucket, so every batch is (budget // bucket, bucket) but the last ones."""

    def __init__(self, dataset, max_token_budget: int = 4096, buckets: Optional[List[int]] = None):
        self.dataset = dataset
        self.budget = max_token_budget
        self.buckets = sorted(buckets or [128, 192, 256, 384, 512])

    def batch_size_for(self, bucket: int) -> int:
        return max(1, self.budget // bucket)

    def __iter__(self):
        queues: Dict[int, List[dict]] = {b: [] for b in self.buckets}
        for item in self.dataset:
            b = bucketize(len(item["input_ids"]), self.buckets)
            q = queues.setdefault(b, [])
            q.append(item)
            if len(q) >= self.batch_size_for(b):
                yield self._collate(q, b)
                queues[b] = []
        for b, q in queues.items():
            if q:
                yield self._collate(q, b)

    def _collate(self, samples: List[dict], bucket: int) -> Dict[str, Any]:
        return SpeechDatasetJsonl.collator(_CollatorShim(self.dataset, bucket), samples)


class _CollatorShim(SpeechDatasetJsonl):
    """The map-style collator's surface (config, tokenizer, inference mode,
    input type) over the iterable dataset, with the text padded to one
    bucket; no manifest is read (the parent's ``__init__`` is not called)."""

    def __init__(self, ds: MultiTaskDataset, bucket: int):  # noqa: super().__init__ not called
        self.config = copy.copy(ds.config)
        self.config.text_buckets = [bucket]
        self.tokenizer = ds.tokenizer
        self.inference_mode = ds.inference_mode
        self.input_type = ds.input_type


def get_speech_dataset_large(dataset_config, tokenizer, split: str, rank: int = 0, world_size: int = 1):
    """The batcher over ``MultiTaskDataset``: ``train_max_frame_length`` (or,
    off the train split, ``eval_max_frame_length``) tokens a batch, over
    ``text_buckets``."""
    ds = MultiTaskDataset(dataset_config, tokenizer, split, rank=rank, world_size=world_size)
    budget = getattr(dataset_config, "train_max_frame_length" if ds.split == "train" else "eval_max_frame_length",
                     4096)
    buckets = list(getattr(dataset_config, "text_buckets", [128, 192, 256, 384, 512]))
    return TokenBudgetBatcher(ds, max_token_budget=budget, buckets=buckets)
