"""AV-HuBERT dataset (VSR / AVSR): lip-crop video, optionally with audio, -> text.

Counterpart of ``slam_llm_tpu/data/avhubert_dataset.py``: jsonl rows
``{key, video, source?, target}``; the video read as grey frames, cropped
to 88 x 88 (at the centre, or at a random offset in training, then a
horizontal flip with probability 0.5) and normalized with AV-HuBERT's
(0.421, 0.165); with ``modal: audio_video`` the ``source`` wav as the 26 x 4
stacked logfbank at the video's 25 fps, both cut to the shorter; the token
assembly of the speech dataset. The collator adds ``visual`` (B, T, 88, 88),
``visual_mask`` (B, T) and, for audio + video, ``audio_feats`` (B, T, 104).

``load_video_gray`` is ``read_gray_frames`` (OpenCV, imported where it is
called) followed by ``crop_and_normalize``; a host without OpenCV can swap
the reader and keep the rest.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List

import numpy as np

from slam_llm_tpu_torch.data.speech_dataset import IGNORE_INDEX, PROMPT_TEMPLATE, SpeechDatasetJsonl
from slam_llm_tpu_torch.models.avhubert import stacked_logfbank
from slam_llm_tpu_torch.ops import audio as audio_ops

DEFAULT_VSR_PROMPT = "Transcribe the silent speech in this video to text. "
CROP = 88
MEAN, STD = 0.421, 0.165


def read_gray_frames(path: str) -> np.ndarray:
    """A video file's frames as (T, H, W) uint8 grey (OpenCV's BGR -> grey)."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
    cap.release()
    if not frames:
        raise ValueError(f"no frames in {path}")
    return np.stack(frames)


def crop_and_normalize(frames: np.ndarray, train: bool = False, rng=None) -> np.ndarray:
    """(T, H, W) uint8 grey frames -> (T, 88, 88) float32: zero-padded up to
    88 where smaller, cropped at the centre (or, in training with ``rng``,
    at a random offset and flipped left-right with probability 0.5), then
    (x / 255 - 0.421) / 0.165."""
    v = frames.astype(np.float32) / 255.0
    t, h, w = v.shape
    if h < CROP or w < CROP:
        v = np.pad(v, ((0, 0), (0, max(0, CROP - h)), (0, max(0, CROP - w))))
        t, h, w = v.shape
    if train and rng is not None:
        y0 = int(rng.integers(0, h - CROP + 1))
        x0 = int(rng.integers(0, w - CROP + 1))
    else:
        y0, x0 = (h - CROP) // 2, (w - CROP) // 2
    v = v[:, y0 : y0 + CROP, x0 : x0 + CROP]
    if train and rng is not None and rng.uniform() < 0.5:
        v = v[:, :, ::-1]  # the reference's RandomHorizontalFlip(0.5)
    return (v - MEAN) / STD


def load_video_gray(path: str, train: bool = False, rng=None) -> np.ndarray:
    """(T, 88, 88) float32 normalized grey frames of a video file."""
    return crop_and_normalize(read_gray_frames(path), train, rng)


class AVHubertDatasetJsonl(SpeechDatasetJsonl):
    def __init__(self, dataset_config, tokenizer=None, split: str = "train"):
        orig = getattr(dataset_config, "input_type", "mel")
        dataset_config.input_type = "mel"  # the parent's raw / mel check; no mel is computed here
        try:
            super().__init__(dataset_config, tokenizer, split)
        finally:
            dataset_config.input_type = orig
        self.modal = getattr(dataset_config, "modal", "video")  # video | audio_video
        self.ds_rate = getattr(dataset_config, "encoder_projector_ds_rate", 5)
        self.rng = np.random.default_rng(42)
        self._rng_lock = threading.Lock()  # the loader reads items from a thread pool
        if getattr(dataset_config, "prompt", None) is None:
            self.prompt = DEFAULT_VSR_PROMPT

    def __getitem__(self, index: int) -> Dict[str, Any]:
        item = self.data_list[index]
        target, key = item.get("target"), item.get("key")
        with self._rng_lock:
            video = load_video_gray(item["video"], train=self.split == "train", rng=self.rng)
        audio_feats = None
        if self.modal == "audio_video" and item.get("source"):
            audio_feats = stacked_logfbank(audio_ops.load_audio(item["source"]))
            t = min(video.shape[0], audio_feats.shape[0])
            video, audio_feats = video[:t], audio_feats[:t]
        audio_length = video.shape[0] // self.ds_rate
        if self.fix_length_audio > 0:
            audio_length = self.fix_length_audio

        prompt_ids = self.tokenizer.encode(PROMPT_TEMPLATE.format(self.prompt))
        prompt_length = len(prompt_ids)
        pseudo = np.full((audio_length,), -1, np.int64)
        base = {"visual": video.astype(np.float32), "audio_feats": audio_feats, "audio_length": audio_length,
                "prompt_length": prompt_length, "key": key, "target": target}
        if self.inference_mode:
            # pseudo ids stay -1: the model clamps them, the repetition penalty skips them
            input_ids = np.concatenate([pseudo, np.asarray(prompt_ids, np.int64)])
            base.update(input_ids=input_ids, attention_mask=np.ones_like(input_ids, np.int32))
            return base
        example = list(self.tokenizer.encode(PROMPT_TEMPLATE.format(self.prompt) + str(target)))
        ids = np.concatenate([pseudo, np.asarray(example + [self.tokenizer.eos_token_id], np.int64)])
        labels = ids.copy()
        labels[: audio_length + prompt_length] = IGNORE_INDEX
        ids[ids == -1] = 0
        base.update(input_ids=ids, labels=labels, attention_mask=np.ones_like(ids, np.int32))
        return base

    def collator(self, samples: List[Dict[str, Any]]) -> Dict[str, Any]:
        out = self.collate_text(samples)
        b = len(samples)
        t_max = max(s["visual"].shape[0] for s in samples)
        visual = np.zeros((b, t_max, CROP, CROP), np.float32)
        visual_mask = np.zeros((b, t_max), np.int32)
        for i, s in enumerate(samples):
            t = s["visual"].shape[0]
            visual[i, :t] = s["visual"]
            visual_mask[i, :t] = 1
        out["visual"], out["visual_mask"] = visual, visual_mask
        if samples[0].get("audio_feats") is not None:
            feats = np.zeros((b, t_max, samples[0]["audio_feats"].shape[1]), np.float32)
            for i, s in enumerate(samples):
                if s["audio_feats"] is not None:
                    t = min(s["audio_feats"].shape[0], t_max)
                    feats[i, :t] = s["audio_feats"][:t]
            out["audio_feats"] = feats
        return out


def get_avhubert_dataset(dataset_config, tokenizer, split: str) -> AVHubertDatasetJsonl:
    return AVHubertDatasetJsonl(dataset_config, tokenizer, split)
