"""Shared conv / activation / checkpoint-folding glue of the vocoders.

Counterpart of ``slam_llm_tpu/ops/torch_port.py`` (its bicubic resize is
``ops/resize.py``) for ``models/{snac,hift,cosyvoice_flow}.py``. The
vocoders keep their weights in the JAX package's dilated-conv form (a
ConvTranspose1d stored as a flipped (O, I, K) kernel run over the input
dilated by its stride); ``conv1d_nct`` runs that form as the equivalent
``conv_transpose1d`` where one exists, so no zeros are inserted.

Precision: every product here is f32. cuDNN runs f32 convolutions as TF32
unless ``torch.backends.cudnn.allow_tf32`` is off; ``f32_convolutions``
turns it off for the extent of a vocoder call and back on after, so the
card computes what the CPU computes.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


def to_np(v) -> np.ndarray:
    """torch tensor or array-like -> float32 numpy."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float().numpy()
    return np.asarray(v, np.float32)


def f32_convolutions():
    """A context in which cuDNN's f32 convolutions stay f32 (TF32 off); the
    flag is restored on exit."""
    return torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled, allow_tf32=False)


def conv1d_nct(
    x: torch.Tensor, w_oik: torch.Tensor, b: Optional[torch.Tensor], *, stride: int = 1, padding: int = 0,
    dilation: int = 1, groups: int = 1, lhs_dilation: int = 1, pad_hi: Optional[int] = None,
) -> torch.Tensor:
    """torch-Conv1d semantics on (B, C, T); weight (O, I/groups, K).
    ``lhs_dilation`` with the (``padding``, ``pad_hi``) pair expresses
    ConvTranspose1d: it runs as ``conv_transpose1d`` of the unflipped
    (I, O, K) kernel when the pads allow, else over the zero-dilated input."""
    pad_lo = padding
    pad_hi = padding if pad_hi is None else pad_hi
    k = w_oik.shape[-1]
    if lhs_dilation > 1:
        tpad, extra = (k - 1) * dilation - pad_lo, pad_hi - pad_lo
        if groups == 1 and dilation == 1 and stride == 1 and tpad >= 0 and 0 <= extra < lhs_dilation:
            w_iok = w_oik.flip(-1).transpose(0, 1)
            return F.conv_transpose1d(x, w_iok, b, stride=lhs_dilation, padding=tpad, output_padding=extra)
        bsz, c, t = x.shape
        xd = x.new_zeros(bsz, c, (t - 1) * lhs_dilation + 1)
        xd[:, :, ::lhs_dilation] = x
        x = xd
    if pad_lo != pad_hi or pad_lo < 0:
        x = F.pad(x, (pad_lo, pad_hi))
        pad_lo = 0
    return F.conv1d(x, w_oik, b, stride=stride, padding=pad_lo, dilation=dilation, groups=groups)


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + (1/alpha) sin^2(alpha x); alpha (C,), x (B, C, T)."""
    a = alpha[None, :, None]
    return x + torch.sin(a * x) ** 2 / (a + 1e-9)


def fold_weight_norm(sd: Dict, prefix: str) -> np.ndarray:
    """weight = g * v / ||v|| with the norm over every axis but 0 (torch
    weight_norm's default), from the legacy ``weight_g`` / ``weight_v`` or the
    ``parametrizations.weight.original0/1`` names, or a plain ``weight``."""
    for g_key, v_key in (
        (f"{prefix}.weight_g", f"{prefix}.weight_v"),
        (f"{prefix}.parametrizations.weight.original0", f"{prefix}.parametrizations.weight.original1"),
    ):
        if g_key in sd:
            g, v = to_np(sd[g_key]), to_np(sd[v_key])
            norm = np.sqrt((v * v).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
            return g * v / np.maximum(norm, 1e-12)
    return to_np(sd[f"{prefix}.weight"])


def to_device(params, device) -> object:
    """A converted parameter tree (nested dicts / lists of numpy arrays and
    Python scalars) with every array as an f32 tensor on ``device``, copied
    once at load."""
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [to_device(v, device) for v in params]
    if isinstance(params, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(params, np.float32)).to(device)
    if isinstance(params, torch.Tensor):
        return params.float().to(device)
    return params

