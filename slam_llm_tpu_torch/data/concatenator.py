"""Packing: tokenized samples concatenated into fixed-size blocks.

Counterpart of ``slam_llm_tpu/data/concatenator.py`` (the reference's
``data/concatenator.py`` ``ConcatDataset``). Every block is ``chunk_size``
long, so every batch is (B, chunk_size). No entry point wires it in, as in
the JAX package.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class ConcatDataset:
    """Greedy packing of the ``input_ids`` / ``labels`` / ``attention_mask``
    of each sample, in order, into ``chunk_size`` blocks; the tail that
    fills no block is dropped, as in the reference."""

    def __init__(self, dataset, chunk_size: int = 4096):
        self.chunk_size = chunk_size
        keys = ("input_ids", "labels", "attention_mask")
        buffers: Dict[str, List[int]] = {k: [] for k in keys}
        self.samples: List[Dict[str, np.ndarray]] = []
        for i in range(len(dataset)):
            item = dataset[i]
            for k in keys:
                if k in item:
                    buffers[k].extend(np.asarray(item[k]).reshape(-1).tolist())
            while len(buffers["input_ids"]) >= chunk_size:
                self.samples.append({k: np.asarray(v[:chunk_size], np.int32 if k == "attention_mask" else np.int64)
                                     for k, v in buffers.items() if v})
                buffers = {k: v[chunk_size:] for k, v in buffers.items()}

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.samples[idx]

    def sort_key(self, idx: int) -> int:
        return self.chunk_size

    def collator(self, samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
