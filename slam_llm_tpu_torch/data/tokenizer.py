"""Tokenizer loading.

The reference uses HF ``AutoTokenizer`` (reference models/slam_model.py:54-65)
with ``pad_token = eos_token`` fallback. We wrap the same, plus a dependency-
free byte-level tokenizer for tests and CPU-runnable example recipes.
Counterpart of ``slam_llm_tpu/data/tokenizer.py``.
"""

from __future__ import annotations

from typing import List, Optional


class ByteTokenizer:
    """Deterministic byte-level tokenizer: ids 0..255 = bytes, then specials.

    Used by tests and the tiny end-to-end recipe; interface-compatible with
    the HF tokenizer surface the framework touches (encode/decode,
    bos/eos/pad ids).
    """

    def __init__(self):
        self.bos_token_id = 256
        self.eos_token_id = 257
        self.pad_token_id = 258
        self.vocab_size = 259

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_token_id] + ids) if add_bos else ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        bs = bytes(i for i in ids if 0 <= int(i) < 256)
        return bs.decode("utf-8", errors="ignore")

    def __call__(self, text: str):
        return {"input_ids": self.encode(text)}


class HFTokenizerWrapper:
    """Thin adapter so framework code sees one tokenizer interface."""

    def __init__(self, tok):
        self.tok = tok
        if tok.pad_token_id is None:
            tok.pad_token_id = tok.eos_token_id  # reference slam_model.py:64
        self.bos_token_id = tok.bos_token_id
        self.eos_token_id = tok.eos_token_id
        self.pad_token_id = tok.pad_token_id
        self.vocab_size = len(tok)

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        # HF adds bos via add_special_tokens when the template does
        return self.tok.encode(text)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        import numpy as np

        ids = [int(i) for i in np.asarray(ids).reshape(-1) if int(i) >= 0]
        return self.tok.decode(ids, skip_special_tokens=skip_special_tokens)


def load_tokenizer(llm_path: Optional[str]):
    """HF tokenizer from a checkpoint dir, or the byte tokenizer when no
    path is configured (tests / synthetic recipes)."""
    if llm_path in (None, "", "byte"):
        return ByteTokenizer()
    from transformers import AutoTokenizer

    return HFTokenizerWrapper(AutoTokenizer.from_pretrained(llm_path, use_fast=True))
