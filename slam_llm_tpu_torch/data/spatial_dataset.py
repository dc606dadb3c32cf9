"""Spatial SoundQA (BAT / SELD) dataset: anechoic clips spatialised with
binaural room impulse responses.

Counterpart of ``slam_llm_tpu/data/spatial_dataset.py``. Each QA item names
an AudioSet clip (``audio_id``) and a 2-channel reverb IR (``reverb_id``, a
``.npy`` under ``{reverb_data_root}/{channel_type}/``): the clip is read as
32 kHz mono, loudness-normalised to -14 dBFS, convolved with the IR
(``scipy.signal.fftconvolve``), averaged with a second spatialised source
when the item has one, and padded or cut to exactly 10 s. The prompt is
BAT's Alpaca template without input, and the audio takes
``fix_length_audio`` slots (64, the Q-Former's queries). The collator
stacks the stereo clips and computes the (B, 4, 1001, 128) binaural
feature map on the host (``models.spatial_ast.binaural_features``) as
``audio_binaural``.

Manifests: the reference's ``{qa_data_root}/{stage}/{split}.json`` (a
``{"data": [...]}`` list; the split's aliases val / eval / test /
validation are tried in turn), else a jsonl through ``train_data_path`` /
``val_data_path``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from slam_llm_tpu_torch.data.speech_dataset import IGNORE_INDEX, SpeechDatasetJsonl
from slam_llm_tpu_torch.ops import audio as audio_ops

SPATIAL_SR = 32000
CLIP_SECONDS = 10

PROMPT_NO_INPUT = (
    "Based on the audio you've heard, refer to the instruction and provide a "
    "response.\n\n### Instruction:\n{instruction}\n\n### Response:"
)


def format_prompt(instruction: str) -> str:
    return PROMPT_NO_INPUT.format(instruction=instruction)


def normalize_audio(x: np.ndarray, target_dbfs: float = -14.0) -> np.ndarray:
    """RMS loudness normalisation to ``target_dbfs``; silence passes through."""
    rms = float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))
    if rms == 0.0:
        return x
    gain = 10.0 ** ((target_dbfs - 20.0 * np.log10(rms)) / 20.0)
    return (x * gain).astype(np.float32)


def spatialize(wav: np.ndarray, reverb: Optional[np.ndarray], n_samples: int) -> np.ndarray:
    """Mono (T,) and an IR (C, L) -> (C, n_samples) f32: the full
    convolution, then zero-padded or cut on the right."""
    from scipy import signal

    x = wav.reshape(1, -1)
    if reverb is not None:
        x = signal.fftconvolve(x, np.asarray(reverb, np.float32), mode="full")
    pad = n_samples - x.shape[1]
    x = np.pad(x, ((0, 0), (0, pad))) if pad >= 0 else x[:, :n_samples]
    return np.ascontiguousarray(x, dtype=np.float32)


class SpatialAudioDatasetJsonl(SpeechDatasetJsonl):
    """QA items over spatialised clips; the collator adds ``audio_binaural``."""

    def __init__(self, dataset_config, tokenizer=None, split: str = "train"):
        super().__init__(dataset_config, tokenizer, split)
        self.normalize = getattr(dataset_config, "normalize", True)
        if self.fix_length_audio <= 0:
            self.fix_length_audio = 64  # the Q-Former's output length
        self.anechoic_data_root = getattr(dataset_config, "anechoic_data_root", "") or ""
        self.reverb_data_root = getattr(dataset_config, "reverb_data_root", "") or ""
        self.channel_type = getattr(dataset_config, "channel_type", "binaural")
        self.ext_audio = getattr(dataset_config, "ext_audio", ".wav")
        self.n_samples = CLIP_SECONDS * SPATIAL_SR

    def read_manifest(self, dataset_config, split: str) -> List[dict]:
        qa_root = getattr(dataset_config, "qa_data_root", None)
        if not qa_root:
            return super().read_manifest(dataset_config, split)
        stage = getattr(dataset_config, "stage", None) or ""
        aliases = {"validation": ("val", "eval", "test"), "val": ("validation", "eval", "test"),
                   "test": ("eval", "val", "validation")}
        paths = [os.path.join(qa_root, stage, name + ".json") for name in (split, *aliases.get(split, ()))]
        with open(next((p for p in paths if os.path.exists(p)), paths[0]), encoding="utf-8") as fin:
            return json.load(fin)["data"]

    def _load_source(self, audio_id: str, reverb_id: Optional[str]) -> np.ndarray:
        wav = audio_ops.load_audio(os.path.join(self.anechoic_data_root, audio_id + self.ext_audio), sr=SPATIAL_SR)
        if self.normalize:
            wav = normalize_audio(wav, -14.0)
        reverb = np.load(os.path.join(self.reverb_data_root, self.channel_type, reverb_id)) if reverb_id else None
        return spatialize(wav, reverb, self.n_samples)

    def load_waveform(self, item: Dict[str, Any]) -> np.ndarray:
        """(2, 320000) stereo: a two-source item averages its sources, each
        spatialised on its own; a mono IR is duplicated onto both channels."""
        wav = self._load_source(item["audio_id"], item.get("reverb_id"))
        if item.get("audio_id2") is not None and item.get("reverb_id2") is not None:
            wav = (wav + self._load_source(item["audio_id2"], item["reverb_id2"])) / 2
        if wav.shape[0] == 1:
            wav = np.repeat(wav, 2, axis=0)
        return wav

    def __getitem__(self, index: int) -> Dict[str, Any]:
        item = self.data_list[index]
        prompt = format_prompt(item["question"])
        answer = str(item["answer"])
        audio_length = self.fix_length_audio
        prompt_ids = self.tokenizer.encode(prompt)
        prompt_length = len(prompt_ids)
        audio_pseudo = np.full((audio_length,), -1, dtype=np.int64)
        common = {"audio_stereo": self.load_waveform(item), "audio_length": audio_length,
                  "prompt_length": prompt_length,
                  "key": f"{item.get('question_type', 'qa')}-{item.get('question_id', index)}", "target": answer}
        if self.inference_mode:
            input_ids = np.concatenate([audio_pseudo, np.asarray(prompt_ids, np.int64)])
            return {"input_ids": input_ids, "attention_mask": np.ones_like(input_ids, dtype=np.int32), **common}
        example = list(self.tokenizer.encode(prompt + answer)) + [self.tokenizer.eos_token_id]
        example_ids = np.concatenate([audio_pseudo, np.asarray(example, np.int64)])
        labels = example_ids.copy()
        labels[: audio_length + prompt_length] = IGNORE_INDEX
        input_ids = example_ids.copy()
        input_ids[input_ids == -1] = 0
        return {"input_ids": input_ids, "labels": labels, "attention_mask": np.ones_like(input_ids, dtype=np.int32),
                **common}

    def collator(self, samples: List[Dict[str, Any]]) -> Dict[str, Any]:
        from slam_llm_tpu_torch.models.spatial_ast import binaural_features

        out = self.collate_text(samples)
        out["audio_binaural"] = binaural_features(np.stack([s["audio_stereo"] for s in samples]))
        return out

    def sort_key(self, index: int) -> int:
        # every clip is 10 s: the answer's length is the only variance
        return len(str(self.data_list[index].get("answer", "")))


def get_spatial_audio_dataset(dataset_config, tokenizer, split: str) -> SpatialAudioDatasetJsonl:
    return SpatialAudioDatasetJsonl(dataset_config, tokenizer, split)
