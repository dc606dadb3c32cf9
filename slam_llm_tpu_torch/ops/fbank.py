"""Kaldi-compatible log-mel filterbank features (EAT / BEATs preprocess).

Counterpart of ``slam_llm_tpu/ops/fbank.py``: the numpy host code the
audio-captioning dataset runs, with the same dtypes (float64 banks rounded
to float32, float32 out). The reference computes these features with
``torchaudio.compliance.kaldi.fbank`` (``htk_compat=True``,
``window='hanning'``, ``num_mel_bins=128``, ``dither=0.0``,
``frame_shift=10``); this implementation follows that path:

  * snip-edges framing (25 ms / 10 ms), per-frame DC removal,
    preemphasis 0.97, symmetric Hann window, zero-pad to 512-point rFFT;
  * HTK-scale (1127 ln(1+f/700)) triangular mel banks, low=20 Hz, high=Nyquist;
  * log(max(power, eps)).

``eat_preprocess`` / ``beats_preprocess`` reproduce the reference's padding,
cropping and normalisation conventions. ``logfbank_psf`` is the other
frontend: python_speech_features' log filterbank, which AV-HuBERT's audio
features are built on.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np

EPS = 1.1920928955078125e-07  # torch float32 eps, kaldi energy floor


def _hz_to_mel_htk(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (np.exp(np.asarray(m, np.float64) / 1127.0) - 1.0)


@functools.lru_cache(maxsize=8)
def kaldi_mel_banks(
    num_bins: int = 128,
    n_fft: int = 512,
    sample_rate: int = 16000,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """(num_bins, n_fft//2) triangular banks over HTK mel scale.

    Kaldi computes banks over FFT bins [0, n_fft/2) (excludes Nyquist)."""
    if high_freq <= 0.0:
        high_freq = sample_rate / 2.0 + high_freq
    fft_freqs = np.arange(n_fft // 2) * (sample_rate / n_fft)
    mel_low = _hz_to_mel_htk(low_freq)
    mel_high = _hz_to_mel_htk(high_freq)
    mel_points = np.linspace(mel_low, mel_high, num_bins + 2)
    mel_of_bin = _hz_to_mel_htk(fft_freqs)
    banks = np.zeros((num_bins, n_fft // 2), np.float64)
    for i in range(num_bins):
        left, center, right = mel_points[i], mel_points[i + 1], mel_points[i + 2]
        up = (mel_of_bin - left) / (center - left)
        down = (right - mel_of_bin) / (right - center)
        banks[i] = np.maximum(0.0, np.minimum(up, down))
    return banks.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _hann_symmetric(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n - 1))).astype(np.float32)


def fbank(
    waveform: np.ndarray,
    num_mel_bins: int = 128,
    sample_rate: int = 16000,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    preemphasis: float = 0.97,
    remove_dc_offset: bool = True,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """waveform (S,) float32 -> (T, num_mel_bins) log-mel, kaldi semantics.

    NOTE: kaldi/torchaudio operate on int16-scale waveforms; pass the same
    scale the reference passes (whisper-style [-1, 1] floats work too — only
    an additive log constant differs, removed by the mean/std normalize)."""
    x = np.asarray(waveform, np.float32)
    win = int(sample_rate * frame_length_ms / 1000)  # 400
    hop = int(sample_rate * frame_shift_ms / 1000)  # 160
    n_fft = 1 << (win - 1).bit_length()  # 512
    if len(x) < win:
        return np.zeros((0, num_mel_bins), np.float32)
    n_frames = 1 + (len(x) - win) // hop  # snip_edges=True

    idx = np.arange(win)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = x[idx].astype(np.float64)
    if remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if preemphasis != 0.0:
        shifted = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - preemphasis * shifted
    frames = frames * _hann_symmetric(win)

    spec = np.fft.rfft(frames, n=n_fft, axis=1)
    power = np.abs(spec[:, : n_fft // 2]) ** 2  # kaldi excludes Nyquist bin
    mel = power @ kaldi_mel_banks(num_mel_bins, n_fft, sample_rate, low_freq, high_freq).T
    return np.log(np.maximum(mel, EPS)).astype(np.float32)


def eat_preprocess(
    waveform: np.ndarray,
    norm_mean: float = -4.268,
    norm_std: float = 4.569,
    target_length: int = 1024,
    fixed_length: bool = False,
    random_crop: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Reference models/EAT/EAT.py:5-32 parity: mean-subtract, fbank 128,
    pad to multiple of 16 (or fixed target), (x - mean) / (2 * std)."""
    x = np.asarray(waveform, np.float32)
    x = x - x.mean()
    mel = fbank(x, num_mel_bins=128)
    n = mel.shape[0]
    if not fixed_length:
        target_length = n if n % 16 == 0 else n + (16 - n % 16)
    diff = target_length - n
    if diff > 0:
        mel = np.pad(mel, ((0, diff), (0, 0)))
    elif diff < 0:
        if random_crop:
            start = (rng or np.random.default_rng()).integers(0, n - target_length + 1)
            mel = mel[start : start + target_length]
        else:
            mel = mel[:target_length]
    return (mel - norm_mean) / (norm_std * 2.0)


def beats_preprocess(
    waveform: np.ndarray, fbank_mean: float = 15.41663, fbank_std: float = 6.55582
) -> np.ndarray:
    """Reference models/BEATs/BEATs.py preprocess parity: int16-scale fbank
    then (x - mean) / (2 * std)."""
    x = np.asarray(waveform, np.float32) * 32768.0  # BEATs expects int16 scale
    mel = fbank(x, num_mel_bins=128)
    return (mel - fbank_mean) / (2.0 * fbank_std)


# ---------------------------------------------------------------------------
# python_speech_features logfbank (AV-HuBERT's audio frontend)
# ---------------------------------------------------------------------------


def _psf_mel_banks(nfilt: int, nfft: int, sr: int, lowfreq: float, highfreq: float) -> np.ndarray:
    """python_speech_features.get_filterbanks: HTK mel points, bins via
    floor((nfft+1) * hz / sr), un-normalized triangles."""

    def hz2mel(h):
        return 2595.0 * np.log10(1.0 + np.asarray(h, np.float64) / 700.0)

    def mel2hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    mels = np.linspace(hz2mel(lowfreq), hz2mel(highfreq), nfilt + 2)
    bins = np.floor((nfft + 1) * mel2hz(mels) / sr).astype(int)
    fb = np.zeros((nfilt, nfft // 2 + 1))
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fb[j, i] = (i - bins[j]) / max(bins[j + 1] - bins[j], 1)
        for i in range(bins[j + 1], bins[j + 2]):
            fb[j, i] = (bins[j + 2] - i) / max(bins[j + 2] - bins[j + 1], 1)
    return fb


def logfbank_psf(
    signal: np.ndarray,
    samplerate: int = 16000,
    winlen: float = 0.025,
    winstep: float = 0.01,
    nfilt: int = 26,
    nfft: int = 512,
    lowfreq: float = 0.0,
    highfreq: Optional[float] = None,
    preemph: float = 0.97,
) -> np.ndarray:
    """python_speech_features.logfbank with its defaults, the frontend the
    AV-HuBERT checkpoints were trained on. It differs from ``fbank`` above
    in every detail that matters to a frozen checkpoint: a rectangular
    window, no per-frame DC removal, lowfreq 0, ceil framing with a zero
    pad, the power spectrum |rfft|^2 / NFFT and the natural log."""
    highfreq = highfreq or samplerate / 2
    x = np.asarray(signal, np.float64)
    x = np.append(x[0], x[1:] - preemph * x[:-1])
    frame_len = int(round(winlen * samplerate))
    frame_step = int(round(winstep * samplerate))
    slen = len(x)
    numframes = 1 if slen <= frame_len else 1 + int(math.ceil((slen - frame_len) / frame_step))
    padlen = (numframes - 1) * frame_step + frame_len
    x = np.concatenate([x, np.zeros(max(padlen - slen, 0))])
    idx = np.arange(frame_len)[None, :] + frame_step * np.arange(numframes)[:, None]
    pspec = (np.abs(np.fft.rfft(x[idx], nfft)) ** 2) / nfft
    feat = pspec @ _psf_mel_banks(nfilt, nfft, samplerate, lowfreq, highfreq).T
    feat = np.where(feat == 0, np.finfo(np.float64).eps, feat)
    return np.log(feat).astype(np.float32)
