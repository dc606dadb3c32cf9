"""The msgpack subset that flax's ``msgpack_serialize`` / ``msgpack_restore`` use.

The port's own codec for the JAX package's ``model.msgpack``
(``slam_llm_tpu/utils/checkpoint.py``: ``save_trainable`` /
``load_trainable``), so that neither ``msgpack`` nor ``flax`` is needed:

* nil, bool, ints (fixint, int / uint 8-64), float 32 / 64, str, bin,
  array and map in all their widths;
* ext type 1, an ndarray: the nested msgpack of ``(shape, dtype name,
  C-order bytes)``; it decodes to a CPU ``torch.Tensor`` (``bfloat16``
  included), and ``torch.Tensor`` / ``numpy.ndarray`` encode to it;
* ext type 3, a numpy scalar: the same nested form with a 0-d shape; it
  decodes to a 0-d tensor, and ``numpy.generic`` encodes to it;
* arrays above flax's ``MAX_CHUNK_SIZE`` (2**30 bytes) arrive as
  ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
  maps; ``restore`` reassembles them and ``serialize`` writes them so.

Other ext types (flax's ext 2, native complex) raise.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "bool": torch.bool,
}
_DTYPE_NAMES = {dt: name for name, dt in _TORCH_DTYPES.items()}


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int) and not isinstance(obj, np.integer):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(0xA0 | n)
        else:
            _pack_len(n, out, 0xD9, 0xDA, 0xDB)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), out, 0xC4, 0xC5, 0xC6)
        out += data
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        else:
            _pack_len(n, out, None, 0xDC, 0xDD)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        else:
            _pack_len(n, out, None, 0xDE, 0xDF)
        for key, val in obj.items():
            _pack(key, out)
            _pack(val, out)
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        _pack_ext(EXT_NDARRAY, _array_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_bytes(np.asarray(obj)), out)
    else:
        raise TypeError(f"cannot msgpack-encode {type(obj).__name__}")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32),
                               (0xCF, ">Q", 1 << 64)):
            if v < lim:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack's uint64")
    else:
        for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15), (0xD2, ">i", 1 << 31),
                               (0xD3, ">q", 1 << 63)):
            if v >= -lim:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack's int64")


def _pack_len(n: int, out: bytearray, c8, c16, c32) -> None:
    if c8 is not None and n < 1 << 8:
        out.append(c8)
        out.append(n)
    elif n < 1 << 16:
        out.append(c16)
        out += struct.pack(">H", n)
    elif n < 1 << 32:
        out.append(c32)
        out += struct.pack(">I", n)
    else:
        raise OverflowError(f"msgpack object of {n} bytes / items exceeds 2**32 - 1")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(n, out, 0xC7, 0xC8, 0xC9)
    out.append(code)
    out += data


def _array_bytes(arr) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``packb((shape, dtype name, C-order bytes))``."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype not in _DTYPE_NAMES:
            raise TypeError(f"cannot msgpack-encode a {arr.dtype} tensor")
        t = arr.detach().to("cpu").contiguous()
        name, data = _DTYPE_NAMES[t.dtype], t.reshape(-1).view(torch.uint8).numpy().tobytes()
        shape = tuple(t.shape)
    else:
        name, data, shape = arr.dtype.name, np.ascontiguousarray(arr).tobytes(), arr.shape
    return packb((tuple(int(d) for d in shape), name, data))


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def unpackb(data: bytes) -> Any:
    obj, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"msgpack: {len(data) - pos} trailing bytes after the object")
    return obj


def _unpack(buf: memoryview, pos: int) -> Tuple[Any, int]:
    b = buf[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _unpack_map(buf, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _unpack_array(buf, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return str(buf[pos:pos + n], "utf-8"), pos + n
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in (0xC4, 0xC5, 0xC6):  # bin 8 / 16 / 32
        n, pos = _read_len(buf, pos, b - 0xC4)
        return bytes(buf[pos:pos + n]), pos + n
    if b in (0xC7, 0xC8, 0xC9):  # ext 8 / 16 / 32
        n, pos = _read_len(buf, pos, b - 0xC7)
        return _ext(buf[pos], bytes(buf[pos + 1:pos + 1 + n])), pos + 1 + n
    if b == 0xCA:
        return struct.unpack_from(">f", buf, pos)[0], pos + 4
    if b == 0xCB:
        return struct.unpack_from(">d", buf, pos)[0], pos + 8
    if 0xCC <= b <= 0xD3:  # uint 8-64, int 8-64
        fmt = (">B", ">H", ">I", ">Q", ">b", ">h", ">i", ">q")[b - 0xCC]
        return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)
    if 0xD4 <= b <= 0xD8:  # fixext 1 / 2 / 4 / 8 / 16
        n = 1 << (b - 0xD4)
        return _ext(buf[pos], bytes(buf[pos + 1:pos + 1 + n])), pos + 1 + n
    if b in (0xD9, 0xDA, 0xDB):  # str 8 / 16 / 32
        n, pos = _read_len(buf, pos, b - 0xD9)
        return str(buf[pos:pos + n], "utf-8"), pos + n
    if b in (0xDC, 0xDD):
        n, pos = _read_len(buf, pos, b - 0xDC + 1)
        return _unpack_array(buf, pos, n)
    if b in (0xDE, 0xDF):
        n, pos = _read_len(buf, pos, b - 0xDE + 1)
        return _unpack_map(buf, pos, n)
    raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at offset {pos - 1}")


def _read_len(buf: memoryview, pos: int, width: int) -> Tuple[int, int]:
    fmt = (">B", ">H", ">I")[width]
    return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)


def _unpack_array(buf, pos, n):
    out = []
    for _ in range(n):
        item, pos = _unpack(buf, pos)
        out.append(item)
    return out, pos


def _unpack_map(buf, pos, n):
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos)
        out[key], pos = _unpack(buf, pos)
    return out, pos


def _ext(code: int, data: bytes):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"msgpack ext type {code} is not supported (1 ndarray and 3 numpy scalar are)")
    shape, name, raw = unpackb(data)
    name = name.decode() if isinstance(name, bytes) else name
    if name not in _TORCH_DTYPES:
        raise ValueError(f"msgpack ndarray of dtype {name!r} is not supported")
    dtype = _TORCH_DTYPES[name]
    if not raw:
        return torch.empty(tuple(shape), dtype=dtype)
    return torch.frombuffer(bytearray(raw), dtype=dtype).reshape(tuple(shape))


# ---------------------------------------------------------------------------
# flax's tree layer: chunked arrays
# ---------------------------------------------------------------------------


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _chunk(arr) -> dict:
    flat = arr.reshape(-1)
    size = max(1, MAX_CHUNK_SIZE // (arr.element_size() if isinstance(arr, torch.Tensor) else arr.itemsize))
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_tree(node):
    if isinstance(node, dict):
        return {k: _chunk_tree(v) for k, v in node.items()}
    if isinstance(node, (torch.Tensor, np.ndarray)) and _nbytes(node) > MAX_CHUNK_SIZE:
        return _chunk(node)
    return node


def _unchunk_tree(node):
    if isinstance(node, dict):
        if CHUNKED in node:
            shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
            chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return {k: _unchunk_tree(v) for k, v in node.items()}
    return node


def serialize(tree) -> bytes:
    """flax's ``msgpack_serialize``: a tree of dicts, lists and array leaves,
    arrays above ``MAX_CHUNK_SIZE`` bytes written as chunked maps."""
    return packb(_chunk_tree(tree))


def restore(data: bytes):
    """flax's ``msgpack_restore``: arrays come back as CPU tensors, chunked
    ones reassembled."""
    return _unchunk_tree(unpackb(data))
