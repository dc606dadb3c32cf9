"""Bicubic resize with ``align_corners=True``, as torch's ``F.interpolate``.

Counterpart of ``_cubic_matrix`` / ``resize_bicubic_align_corners`` in
``slam_llm_tpu/ops/torch_port.py``: each axis is one product with a
(out, in) matrix of the cubic-convolution kernel (a = -0.75, border-clamped
taps), built in f64 on the host and applied in f32. HTSAT pads a short mel
to its 1024-frame target this way.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def cubic_matrix(t_in: int, t_out: int) -> np.ndarray:
    """(t_out, t_in) f32 interpolation matrix along one axis."""
    a = -0.75
    if t_out == t_in:
        return np.eye(t_out, dtype=np.float32)
    src = np.arange(t_out, dtype=np.float64) * (t_in - 1) / max(t_out - 1, 1)
    base = np.floor(src).astype(np.int64)
    f = src - base

    def k(x):
        x = np.abs(x)
        return np.where(
            x <= 1,
            (a + 2) * x**3 - (a + 3) * x**2 + 1,
            np.where(x < 2, a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a, 0.0),
        )

    w = np.zeros((t_out, t_in), np.float64)
    for tap in (-1, 0, 1, 2):
        idx = np.clip(base + tap, 0, t_in - 1)
        np.add.at(w, (np.arange(t_out), idx), k(f - tap))
    return w.astype(np.float32)


def resize_bicubic_align_corners(x: torch.Tensor, out_t: int, out_f: int) -> torch.Tensor:
    """(B, C, T, F) -> (B, C, out_t, out_f)."""
    t, f = x.shape[2], x.shape[3]
    if t != out_t:
        wt = torch.from_numpy(cubic_matrix(t, out_t)).to(x.device, x.dtype)
        x = torch.einsum("ot,bctf->bcof", wt, x)
    if f != out_f:
        wf = torch.from_numpy(cubic_matrix(f, out_f)).to(x.device, x.dtype)
        x = torch.einsum("pf,bctf->bctp", wf, x)
    return x
