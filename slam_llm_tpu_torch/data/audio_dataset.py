"""Audio-captioning jsonl dataset (EAT/BEATs fbank input).

Counterpart of ``slam_llm_tpu/data/audio_dataset.py``, over the port's own
speech dataset and Kaldi fbank. Mirrors reference
``datasets/audio_dataset.py``: kaldi fbank via the encoder-specific
preprocess, audio_length = post-patch-embed length // projector ds_rate
(beats: (T+1)//2, eat: T//2 + 1 incl. CLS — reference :113-118), same
[audio, prompt, answer, eos] assembly + collation as the speech dataset.
Unreadable audio degrades to 1 s of silence (reference :81-89). A config
without a prompt gets ``DEFAULT_AAC_PROMPT`` (the JAX package gives it the
speech dataset's ASR prompt instead: ROADMAP Queue 3). Each item carries
``audio_seconds``, the clip's length before any crop or pad, which the
collator sums for the RTF (the JAX items carry none, so its RTF counts the
fbank mask: 10.24 s for every fixed-length clip)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from slam_llm_tpu_torch.data.speech_dataset import (
    IGNORE_INDEX,
    PROMPT_TEMPLATE,
    SpeechDatasetJsonl,
)
from slam_llm_tpu_torch.ops import audio as audio_ops
from slam_llm_tpu_torch.ops import fbank as fbank_ops

DEFAULT_AAC_PROMPT = "Describe the audio you hear. "


class AudioDatasetJsonl(SpeechDatasetJsonl):
    def __init__(self, dataset_config, tokenizer=None, split: str = "train"):
        # bypass parent's input_type assert WITHOUT leaving the shared
        # config mutated (fbank is its own input type)
        orig = getattr(dataset_config, "input_type", "mel")
        dataset_config.input_type = "mel"
        try:
            super().__init__(dataset_config, tokenizer, split)
        finally:
            dataset_config.input_type = orig
        self.model_name = getattr(dataset_config, "encoder_name", "eat")
        self.fbank_mean = getattr(dataset_config, "fbank_mean", -4.268)
        self.fbank_std = getattr(dataset_config, "fbank_std", 4.569)
        self.target_length = getattr(dataset_config, "target_length", 1024)
        self.fixed_length = getattr(dataset_config, "fixed_length", True)
        self.random_crop = getattr(dataset_config, "random_crop", False) and split == "train"
        # seeded, thread-safe crop rng (unseeded default_rng() per call was
        # irreproducible under a fixed seed; prefetch collates from threads)
        self._crop_rng = np.random.default_rng(getattr(dataset_config, "seed", 0) + 555)
        self.ds_rate = getattr(dataset_config, "encoder_projector_ds_rate", 5)
        # a config without a prompt gets the captioning one; the JAX package
        # tests the parent's prompt, which the parent has already defaulted
        # to the ASR prompt, so its DEFAULT_AAC_PROMPT is never reached
        self.prompt = getattr(dataset_config, "prompt", None) or DEFAULT_AAC_PROMPT

    def _crop_child_rng(self):
        with self._specaug_lock:
            return np.random.default_rng(int(self._crop_rng.integers(2**63)))

    def __getitem__(self, index: int) -> Dict[str, Any]:
        item = self.data_list[index]
        target = item.get("target")
        key = item.get("key")
        try:
            audio_raw = audio_ops.load_audio(item.get("source"))
            if len(audio_raw) == 0:
                raise ValueError("empty audio")
        except Exception:
            audio_raw = np.zeros(16000, np.float32)  # reference :89
        audio_seconds = len(audio_raw) / audio_ops.SAMPLE_RATE  # before the crop / pad

        if self.model_name == "beats":
            mel = fbank_ops.beats_preprocess(
                audio_raw, fbank_mean=self.fbank_mean, fbank_std=self.fbank_std
            )
            audio_length = (mel.shape[0] + 1) // 2
        else:  # eat
            mel = fbank_ops.eat_preprocess(
                audio_raw, norm_mean=self.fbank_mean, norm_std=self.fbank_std,
                target_length=self.target_length, fixed_length=self.fixed_length,
                random_crop=self.random_crop,
                rng=self._crop_child_rng() if self.random_crop else None,
            )
            audio_length = mel.shape[0] // 2 + 1  # + CLS token
        audio_length = audio_length // self.ds_rate
        if self.fix_length_audio > 0:
            audio_length = self.fix_length_audio

        prompt_ids = self.tokenizer.encode(PROMPT_TEMPLATE.format(self.prompt + " "))
        prompt_length = len(prompt_ids)
        audio_pseudo = np.full((audio_length,), -1, dtype=np.int64)

        if self.inference_mode:
            input_ids = np.concatenate([audio_pseudo, np.asarray(prompt_ids, np.int64)])
            # pseudo ids stay -1 in inference mode: the model clamps before
            # embedding, and generate's repetition penalty uses -1 to exclude
            # audio slots from prompt token counts (speech_dataset contract)
            return {
                "input_ids": input_ids,
                "attention_mask": np.ones_like(input_ids, dtype=np.int32),
                "audio_mel": mel.astype(np.float32),
                "audio_length": audio_length,
                "audio_seconds": audio_seconds,
                "prompt_length": prompt_length,
                "key": key,
                "target": target,
            }

        example_ids = self.tokenizer.encode(PROMPT_TEMPLATE.format(self.prompt + " ") + str(target))
        example_ids = list(example_ids) + [self.tokenizer.eos_token_id]
        example_ids = np.concatenate([audio_pseudo, np.asarray(example_ids, np.int64)])
        labels = example_ids.copy()
        labels[: audio_length + prompt_length] = IGNORE_INDEX
        input_ids = example_ids.copy()
        input_ids[input_ids == -1] = 0
        return {
            "input_ids": input_ids,
            "labels": labels,
            "attention_mask": np.ones_like(input_ids, dtype=np.int32),
            "audio_mel": mel.astype(np.float32),
            "audio_length": audio_length,
            "audio_seconds": audio_seconds,
            "prompt_length": prompt_length,
            "key": key,
            "target": target,
        }


def get_audio_dataset(dataset_config, tokenizer, split: str) -> AudioDatasetJsonl:
    return AudioDatasetJsonl(dataset_config, tokenizer, split)
