"""Reader and writer of the safetensors file format, in plain Python.

Replaces the ``safetensors`` package calls of the reference
(``slam_llm_tpu/utils/hf_loader.py`` reads with ``safe_open``,
``utils/hf_export.py`` writes with ``safetensors.numpy.save_file``). A file is

    8 bytes   little-endian u64: N, the header's length
    N bytes   JSON: {name: {"dtype", "shape", "data_offsets": [begin, end]}, ...,
                     "__metadata__": {str: str}} (optional), padded with spaces
    ...       the tensors' raw little-endian bytes; offsets count from the
              first byte after the header

``load_file`` maps the file and returns each tensor as a view of the map
(``torch.frombuffer``), so bf16 needs no numpy bf16 type and nothing is read
until a tensor is used: a caller converts one tensor at a time into the dtype
and device it keeps, and a 2 GB bf16 checkpoint never takes 4 GB as f32 on
the host. ``torch_load_file`` reads ``pytorch_model*.bin`` / ``*.pt``.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import warnings
from typing import Dict, Mapping, Optional

import torch

DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I8": torch.int8,
    "I32": torch.int32, "I64": torch.int64, "BOOL": torch.bool,
}
_NAMES = {dt: name for name, dt in DTYPES.items()}
METADATA = "__metadata__"


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of a safetensors file, each a CPU view of the
    file's memory map in its stored dtype (``__metadata__`` skipped). A
    dtype other than F32, F16, BF16, I8, I32, I64 and BOOL raises."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        head = f.read(8)
        (n,) = struct.unpack("<Q", head) if len(head) == 8 else (size,)
        if n > size - 8:
            raise ValueError(f"{path}: not a safetensors file (header length {n}, {size} bytes)")
        header, start = json.loads(f.read(n).decode("utf-8")), 8 + n
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) if size > start else None
    out = {}
    for name, info in header.items():
        if name == METADATA:
            continue
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}; "
                             f"supported: {', '.join(DTYPES)}")
        dtype, shape = DTYPES[info["dtype"]], tuple(info["shape"])
        begin, end = info["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        numel = 1
        for d in shape:
            numel *= d
        nbytes = numel * itemsize
        if end - begin != nbytes or start + end > size:
            raise ValueError(f"{path}: tensor {name!r} spans bytes [{begin}, {end}), expected {nbytes} "
                             f"bytes inside the file")
        if nbytes == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        with warnings.catch_warnings():  # the views of the read-only map are only read or copied
            warnings.filterwarnings("ignore", message="The given buffer is not writable")
            raw = torch.frombuffer(mm, dtype=torch.uint8, count=nbytes, offset=start + begin)
        if (start + begin) % itemsize:
            raw = raw.clone()  # a misaligned tensor: copy it once
        out[name] = raw.view(dtype).reshape(shape)
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str, metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write ``{name: tensor}`` as a safetensors file; returns the bytes
    written. Tensors are laid out by element size (largest first) then name,
    so every tensor starts aligned to its element size; the header is padded
    with spaces to a multiple of 8 bytes."""
    order = sorted(tensors, key=lambda n: (-tensors[n].element_size(), n))
    header: Dict[str, object] = {}
    if metadata:
        header[METADATA] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}; supported: {sorted(map(str, _NAMES))}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach().to("cpu").contiguous().reshape(-1)
            if t.numel():
                f.write(memoryview(t.view(torch.uint8).numpy()))
    return 8 + len(blob) + offset


def torch_load_file(path: str) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of a ``torch.save`` checkpoint (``pytorch_model*.bin``
    / ``*.pt``), read with ``weights_only`` in its stored dtypes; a
    ``{"state_dict": ...}`` nest is unwrapped, as the reference's
    ``load_hf_state_dict`` does."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    state = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}
