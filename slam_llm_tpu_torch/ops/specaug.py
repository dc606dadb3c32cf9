"""SpecAugment (time/frequency masking) for mel/fbank features.

Host-side augmentation applied by datasets when ``train_config.specaug`` is
on (Park et al. 2019: F frequency masks + T time masks; no time warp).
Counterpart of ``slam_llm_tpu/ops/specaug.py``."""

from __future__ import annotations

from typing import Optional

import numpy as np


def spec_augment(
    mel: np.ndarray,  # (T, F)
    num_freq_masks: int = 2,
    freq_mask_width: int = 10,
    num_time_masks: int = 2,
    time_mask_width: int = 50,
    mask_value: Optional[float] = None,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    rng = rng or np.random.default_rng()
    out = mel.copy()
    t, f = out.shape
    fill = out.mean() if mask_value is None else mask_value
    for _ in range(num_freq_masks):
        w = int(rng.integers(0, min(freq_mask_width, f) + 1))
        if w:
            f0 = int(rng.integers(0, f - w + 1))
            out[:, f0 : f0 + w] = fill
    for _ in range(num_time_masks):
        w = int(rng.integers(0, min(time_mask_width, max(t - 1, 1)) + 1))
        if w:
            t0 = int(rng.integers(0, t - w + 1))
            out[t0 : t0 + w, :] = fill
    return out
