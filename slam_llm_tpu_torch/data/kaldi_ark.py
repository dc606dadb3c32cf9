"""Kaldi ark reading and writing in plain Python and numpy (no kaldiio).

Counterpart of ``slam_llm_tpu/data/kaldi_ark.py``. ``load_mat`` reads one
entry of an rspecifier ``/path/file.ark:offset`` (or a bare path, from its
start):

* binary float / double matrices (``FM`` / ``DM``) and vectors (``FV`` /
  ``DV``), as float32;
* Kaldi compressed matrices (``CM``, format 1: per-column percentile uint8);
* wav-ark entries (a RIFF payload) as ``(sample_rate, int16 samples)``, the
  first channel of a multi-channel file, as ``kaldiio.load_mat`` returns
  them.

``write_float_matrix`` and ``write_wav_ark`` write arks that ``load_mat``
reads back, returning each entry's rspecifier.
"""

from __future__ import annotations

import io
import struct
import wave
from typing import Tuple, Union

import numpy as np


def _read_int32(f) -> int:
    size = f.read(1)
    if size != b"\x04":
        raise ValueError(f"expected an int32 size marker, got {size!r}")
    return struct.unpack("<i", f.read(4))[0]


def _read_matrix(f, dtype, itemsize):
    rows = _read_int32(f)
    cols = _read_int32(f)
    data = np.frombuffer(f.read(rows * cols * itemsize), dtype=dtype)
    return data.reshape(rows, cols).astype(np.float32)


def _read_vector(f, dtype, itemsize):
    n = _read_int32(f)
    return np.frombuffer(f.read(n * itemsize), dtype=dtype).astype(np.float32)


def _read_compressed(f):
    """Kaldi CompressedMatrix format 1: per column, four uint16 percentiles
    (0, 25, 75, 100) of [min, min + range], and one uint8 a value that
    interpolates linearly between them (0-64, 64-192, 192-255)."""
    min_value, rng = struct.unpack("<ff", f.read(8))
    rows, cols = struct.unpack("<ii", f.read(8))
    pct = np.frombuffer(f.read(cols * 8), dtype="<u2").reshape(cols, 4)

    def uint16_to_float(u):
        return min_value + rng * (u.astype(np.float64) / 65535.0)

    p0, p25, p75, p100 = (uint16_to_float(pct[:, i]) for i in range(4))
    data = np.frombuffer(f.read(rows * cols), dtype=np.uint8).reshape(cols, rows)
    out = np.empty((cols, rows), np.float32)
    lo = data <= 64
    mid = (data > 64) & (data <= 192)
    hi = data > 192
    d = data.astype(np.float64)
    out[lo] = (p0[:, None] + (p25 - p0)[:, None] * (d / 64.0))[lo]
    out[mid] = (p25[:, None] + (p75 - p25)[:, None] * ((d - 64.0) / 128.0))[mid]
    out[hi] = (p75[:, None] + (p100 - p75)[:, None] * ((d - 192.0) / 63.0))[hi]
    return out.T.astype(np.float32)


def load_mat(rspecifier: str) -> Union[np.ndarray, Tuple[int, np.ndarray]]:
    """One entry of ``path.ark:byte_offset`` (or of a bare path, at its
    start): a float32 matrix or vector, or ``(sample_rate, int16
    waveform)`` for a wav-ark entry."""
    if ":" in rspecifier and rspecifier.rsplit(":", 1)[1].isdigit():
        path, off = rspecifier.rsplit(":", 1)
        offset = int(off)
    else:
        path, offset = rspecifier, 0
    with open(path, "rb") as f:
        f.seek(offset)
        head = f.read(2)
        if head == b"RI":  # a RIFF wav payload
            f.seek(offset)
            size = struct.unpack("<I", f.read(12)[4:8])[0]
            f.seek(offset)
            with wave.open(io.BytesIO(f.read(size + 8)), "rb") as w:
                sr = w.getframerate()
                x = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")
                if w.getnchannels() > 1:
                    x = x.reshape(-1, w.getnchannels())[:, 0]
            return sr, x
        if head != b"\x00B":
            raise ValueError(f"not a kaldi binary entry at {rspecifier} ({head!r})")
        token = f.read(3).decode("ascii")
        if token == "FM ":
            return _read_matrix(f, "<f4", 4)
        if token == "DM ":
            return _read_matrix(f, "<f8", 8)
        if token == "FV ":
            return _read_vector(f, "<f4", 4)
        if token == "DV ":
            return _read_vector(f, "<f8", 8)
        if token == "CM ":
            return _read_compressed(f)
        raise ValueError(f"unsupported kaldi binary token {token!r}")


def write_float_matrix(path: str, entries) -> list:
    """``{key: float32 matrix}`` as a binary ark; returns the rspecifiers."""
    specs = []
    with open(path, "wb") as f:
        for key, mat in entries.items():
            f.write(key.encode("ascii") + b" ")
            offset = f.tell()
            mat = np.asarray(mat, np.float32)
            f.write(b"\x00BFM ")
            f.write(b"\x04" + struct.pack("<i", mat.shape[0]))
            f.write(b"\x04" + struct.pack("<i", mat.shape[1]))
            f.write(mat.astype("<f4").tobytes())
            specs.append(f"{path}:{offset}")
    return specs


def write_wav_ark(path: str, entries, sample_rate: int = 16000) -> list:
    """``{key: float32 waveform in [-1, 1]}`` as a wav ark (16-bit mono,
    samples scaled by 32767); returns the rspecifiers."""
    specs = []
    with open(path, "wb") as f:
        for key, x in entries.items():
            f.write(key.encode("ascii") + b" ")
            offset = f.tell()
            buf = io.BytesIO()
            with wave.open(buf, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(sample_rate)
                w.writeframes((np.asarray(x) * 32767).astype("<i2").tobytes())
            f.write(buf.getvalue())
            specs.append(f"{path}:{offset}")
    return specs
