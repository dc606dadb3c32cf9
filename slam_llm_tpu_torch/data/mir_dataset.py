"""Music-captioning jsonl dataset (MusicFM mel input).

Counterpart of ``slam_llm_tpu/data/mir_dataset.py``: 24 kHz music, a 10 s
crop (at a random start from a seeded generator in training, at the start
otherwise; shorter clips are zero-padded), MusicFM's dB mel
(``ops.audio.music_log_mel``: 1001 frames), the caption as the target, and
``audio_length = (T_mel // 4) // ds_rate`` = 50 audio slots at ds 5. A
config without a prompt gets ``DEFAULT_MC_PROMPT``. Token assembly and
collation are the speech dataset's (mel input). Each item carries
``audio_seconds``, the seconds of music its crop holds (a short clip's
zero padding excluded), which the collator sums for the RTF; the JAX
package counts the padded crop's mel frames."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from slam_llm_tpu_torch.data.speech_dataset import IGNORE_INDEX, PROMPT_TEMPLATE, SpeechDatasetJsonl
from slam_llm_tpu_torch.ops import audio as audio_ops

DEFAULT_MC_PROMPT = "Describe the music you hear. "
MUSIC_SR = 24000


class MIRDatasetJsonl(SpeechDatasetJsonl):
    def __init__(self, dataset_config, tokenizer=None, split: str = "train"):
        # the parent's input_type check, without leaving the shared config changed
        orig_input_type = getattr(dataset_config, "input_type", "mel")
        dataset_config.input_type = "mel"
        try:
            super().__init__(dataset_config, tokenizer, split)
        finally:
            dataset_config.input_type = orig_input_type
        self.crop_seconds = getattr(dataset_config, "crop_seconds", 10.0)
        self.ds_rate = getattr(dataset_config, "encoder_projector_ds_rate", 5)
        self.random_crop = split == "train"
        # seeded, drawn under the lock: the prefetch loader collates from threads
        self._crop_rng = np.random.default_rng(getattr(dataset_config, "seed", 0) + 777)
        if getattr(dataset_config, "prompt", None) is None:
            self.prompt = DEFAULT_MC_PROMPT

    def __getitem__(self, index: int) -> Dict[str, Any]:
        item = self.data_list[index]
        target, key = item.get("target"), item.get("key")
        audio_raw = audio_ops.load_audio(item.get("source"), sr=MUSIC_SR)
        crop = int(self.crop_seconds * MUSIC_SR)
        audio_seconds = min(len(audio_raw), crop) / MUSIC_SR  # the music the crop holds, not its zero padding
        if len(audio_raw) > crop:
            start = 0
            if self.random_crop:
                with self._specaug_lock:
                    start = int(self._crop_rng.integers(0, len(audio_raw) - crop))
            audio_raw = audio_raw[start: start + crop]
        else:
            audio_raw = np.pad(audio_raw, (0, crop - len(audio_raw)))
        mel = audio_ops.music_log_mel(audio_raw, sr=MUSIC_SR)
        if self.specaug:
            from slam_llm_tpu_torch.ops.specaug import spec_augment

            with self._specaug_lock:
                child = int(self._specaug_rng.integers(2**63))
            mel = spec_augment(mel, rng=np.random.default_rng(child))
        audio_length = (mel.shape[0] // 4) // self.ds_rate
        if self.fix_length_audio > 0:
            audio_length = self.fix_length_audio

        prompt_ids = self.tokenizer.encode(PROMPT_TEMPLATE.format(self.prompt))
        prompt_length = len(prompt_ids)
        audio_pseudo = np.full((audio_length,), -1, np.int64)
        common = {"audio_mel": mel, "audio_length": audio_length, "prompt_length": prompt_length, "key": key,
                  "target": target, "audio_seconds": audio_seconds}
        if self.inference_mode:
            # pseudo ids stay -1: the repetition penalty excludes audio slots by it
            input_ids = np.concatenate([audio_pseudo, np.asarray(prompt_ids, np.int64)])
            return {"input_ids": input_ids, "attention_mask": np.ones_like(input_ids, np.int32), **common}

        example = list(self.tokenizer.encode(PROMPT_TEMPLATE.format(self.prompt) + str(target)))
        example_ids = np.concatenate([audio_pseudo, np.asarray(example + [self.tokenizer.eos_token_id], np.int64)])
        labels = example_ids.copy()
        labels[: audio_length + prompt_length] = IGNORE_INDEX
        input_ids = example_ids.copy()
        input_ids[input_ids == -1] = 0
        return {"input_ids": input_ids, "labels": labels, "attention_mask": np.ones_like(input_ids, np.int32),
                **common}


def get_mir_dataset(dataset_config, tokenizer, split: str) -> MIRDatasetJsonl:
    return MIRDatasetJsonl(dataset_config, tokenizer, split)
