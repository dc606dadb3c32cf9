"""Whisper-compatible audio frontend, implemented from scratch.

The reference calls ``whisper.load_audio`` / ``whisper.pad_or_trim`` /
``whisper.log_mel_spectrogram`` (reference datasets/speech_dataset.py:93-103).
Neither openai-whisper nor librosa is a dependency here: the mel filterbank
(slaney-scale, slaney-normalized — what librosa.filters.mel produces with
default args) and the periodic-Hann STFT are implemented directly.

Counterpart of ``slam_llm_tpu/ops/audio.py``: its numpy half, which the
data pipeline runs on host threads. The port computes the mel on the host
only.

Semantics matched to whisper/audio.py (public, MIT):
  * N_FFT=400, HOP=160, periodic Hann, center=True with reflect padding
  * power spectrum |STFT|^2 with the final frame dropped
  * log10(clamp(., 1e-10)), floored at (max - 8), then (x + 4) / 4
Output layout here is (T, n_mels) — time-major, the layout the model consumes
(the reference permutes to time-major immediately, speech_dataset.py:103).
"""

from __future__ import annotations

import functools
import shutil
import subprocess
import wave
from pathlib import Path

import numpy as np

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000


# ---------------------------------------------------------------------------
# Loading / padding
# ---------------------------------------------------------------------------


def _read_wav(path: str) -> tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        ch = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = (
            (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8) | (b[:, 2].astype(np.int8).astype(np.int32) << 16))
        ).astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported wav sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def _read_via_ffmpeg(path: str, sr: int) -> np.ndarray:
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(
            f"cannot decode {path}: not a PCM wav and ffmpeg is unavailable"
        )
    cmd = [
        ffmpeg, "-nostdin", "-threads", "0", "-i", path,
        "-f", "s16le", "-ac", "1", "-acodec", "pcm_s16le", "-ar", str(sr), "-",
    ]
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    return np.frombuffer(out, np.int16).astype(np.float32) / 32768.0


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return x
    from scipy.signal import resample_poly
    from math import gcd

    g = gcd(orig_sr, target_sr)
    return resample_poly(x, target_sr // g, orig_sr // g).astype(np.float32)


def load_audio(path: str, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Load any audio file as float32 mono at ``sr`` (whisper.load_audio parity)."""
    p = str(path)
    if Path(p).suffix.lower() == ".wav":
        import wave

        try:
            x, file_sr = _read_wav(p)
        except FileNotFoundError:
            raise  # a missing file is not a format problem — don't misblame ffmpeg
        except (wave.Error, EOFError, ValueError):
            x = None  # non-PCM / malformed wav -> ffmpeg
        if x is not None:
            return resample(x, file_sr, sr)
    if Path(p).suffix.lower() in (".npy",):
        return np.load(p).astype(np.float32)
    return _read_via_ffmpeg(p, sr)


def pad_or_trim(array: np.ndarray, length: int = N_SAMPLES, axis: int = -1):
    """whisper.pad_or_trim parity: right-pad with zeros or trim to ``length``."""
    n = array.shape[axis]
    if n > length:
        sl = [slice(None)] * array.ndim
        sl[axis] = slice(0, length)
        return array[tuple(sl)]
    if n < length:
        widths = [(0, 0)] * array.ndim
        widths[axis] = (0, length - n)
        return np.pad(array, widths)
    return array


# ---------------------------------------------------------------------------
# Mel filterbank (librosa.filters.mel defaults: slaney scale, slaney norm)
# ---------------------------------------------------------------------------


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    hz = m * f_sp
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), hz)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_mels: int = 80, sr: int = SAMPLE_RATE, n_fft: int = N_FFT) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) float32, equal to librosa.filters.mel defaults
    (which is what the whisper assets/mel_filters.npz contain)."""
    fftfreqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _hann_periodic(n: int) -> np.ndarray:
    # torch.hann_window(periodic=True): 0.5 * (1 - cos(2*pi*k/N)), k = 0..N-1
    k = np.arange(n, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * k / n))).astype(np.float32)


# ---------------------------------------------------------------------------
# Log-mel spectrogram
# ---------------------------------------------------------------------------


def _rfft_f32(frames: np.ndarray) -> np.ndarray:
    """Single-precision batched rFFT on the host: numpy's pocketfft upcasts
    real input to float64 (~1.7x slower at the whisper frame shape); torch's
    CPU FFT keeps float32 end-to-end."""
    import torch

    return torch.fft.rfft(torch.from_numpy(frames), dim=-1).numpy()


def log_mel_spectrogram(audio, n_mels: int = 80) -> np.ndarray:
    """Compute the whisper log-mel spectrogram of a 1-D 16 kHz waveform on
    the host. Returns (T, n_mels) float32."""
    audio = np.asarray(audio, dtype=np.float32)
    pad = N_FFT // 2
    padded = np.pad(audio, (pad, pad), mode="reflect")
    n_frames = 1 + (padded.shape[-1] - N_FFT) // HOP_LENGTH
    # strided view framing (no index gather), final frame dropped BEFORE the
    # FFT, f32 FFT, |.|^2 without the sqrt round-trip
    frames = np.lib.stride_tricks.sliding_window_view(padded, N_FFT)
    frames = frames[::HOP_LENGTH][: n_frames - 1] * _hann_periodic(N_FFT)
    spec = _rfft_f32(np.ascontiguousarray(frames))
    mag = spec.real**2 + spec.imag**2
    mel = mag @ mel_filterbank(n_mels).T
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


# ---------------------------------------------------------------------------
# MusicFM's dB mel (the MIR dataset)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def _htk_mel_banks(n_mels: int, sr: int, n_fft: int) -> np.ndarray:
    """HTK-scale unnormalized triangular banks, (n_mels, n_fft // 2 + 1) f32
    (torchaudio MelSpectrogram's defaults: htk scale, norm=None, f_min=0,
    f_max=sr/2)."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    fftfreqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2), n_mels + 2))
    banks = np.zeros((n_mels, 1 + n_fft // 2), np.float64)
    for i in range(n_mels):
        up = (fftfreqs - pts[i]) / (pts[i + 1] - pts[i])
        down = (pts[i + 2] - fftfreqs) / (pts[i + 2] - pts[i + 1])
        banks[i] = np.maximum(0.0, np.minimum(up, down))
    return banks.astype(np.float32)


def music_log_mel(audio, sr: int = 24000, n_fft: int = 2048, hop: int = 240, n_mels: int = 128) -> np.ndarray:
    """MusicFM's dB mel spectrogram (torchaudio MelSpectrogram power 2, HTK
    mel, then AmplitudeToDB with its default top_db=None: no floor). Returns
    (T, n_mels) f32, T = 1 + S // hop (center=True): 1001 frames for 10 s."""
    x = np.asarray(audio, np.float32)
    pad = n_fft // 2
    padded = np.pad(x, (pad, pad), mode="reflect")
    n_frames = 1 + (len(padded) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    spec = np.fft.rfft(padded[idx] * _hann_periodic(n_fft), axis=-1)
    mel = np.abs(spec) ** 2 @ _htk_mel_banks(n_mels, sr, n_fft).T
    return (10.0 * np.log10(np.maximum(mel, 1e-10))).astype(np.float32)
