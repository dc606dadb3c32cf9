"""FENSE (Zhou et al. 2022), the sixth metric column of the AAC recipes.

Counterpart of ``slam_llm_tpu/utils/fense.py``. FENSE is the
max-over-references cosine similarity of sentence embeddings, multiplied by
(1 - 0.9) where a fluency-error detector flags the candidate. Both scorers
are BERT trunks (``models.bert``, f32) read from local files:

* an SBERT directory (``paraphrase-TinyBERT-L6-v2``): the trunk with masked
  mean pooling and L2 normalization, read with the port's own safetensors /
  torch readers (``utils.hf_loader.load_hf_state_dict``), its ``vocab.txt``
  beside the weights;
* an "echecker" ``.ckpt`` (``echecker_clotho_audiocaps_base``): a trunk and a
  linear head (``clf`` or ``classifier``) on the CLS state giving 6 sigmoid
  error probabilities; a candidate is disfluent when any exceeds 0.9.

``WordPieceTokenizer`` is BERT-uncased WordPiece in plain Python over a
``vocab.txt``; it is also CLAP's text tokenizer. The head count is read from
the directory's ``config.json`` where there is one (the JAX package always
assumes d_model / 64 heads, which a 312-wide, 12-head TinyBERT does not
have), else d_model / 64.

    scorer = FenseScorer("/ckpts/paraphrase-TinyBERT-L6-v2", "/ckpts/echecker_base.ckpt")
    compute_caption_metrics(cands, refs, fense_embed_fn=scorer.embed, fense_fluency_fn=scorer.fluency_errors)
"""

from __future__ import annotations

import json
import os
import unicodedata
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from slam_llm_tpu_torch.models.bert import BertConfig, BertEncoder, convert_bert_torch_state


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece over a BERT ``vocab.txt``:
    lower-casing, a split on whitespace and punctuation, then each word's
    pieces with the ``##`` continuation prefix, ``[UNK]`` for a word with no
    match (``transformers.BertTokenizer(do_lower_case=True)`` on standard
    vocabularies)."""

    def __init__(self, vocab_file: str, do_lower_case: bool = True):
        self.vocab: Dict[str, int] = {}
        with open(vocab_file, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.do_lower_case = do_lower_case
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.pad_id = self.vocab["[PAD]"]
        self.unk_id = self.vocab["[UNK]"]
        self.max_word_chars = 100

    @staticmethod
    def _is_punct(ch: str) -> bool:
        cp = ord(ch)
        if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
            return True
        return unicodedata.category(ch).startswith("P")

    def _basic_split(self, text: str) -> List[str]:
        if self.do_lower_case:
            text = text.lower()
        out: List[str] = []
        word: List[str] = []
        for ch in text:
            if ch.isspace() or self._is_punct(ch):
                if word:
                    out.append("".join(word))
                    word = []
                if not ch.isspace():
                    out.append(ch)
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
        return out

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_word_chars:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str, max_len: int = 64) -> List[int]:
        """[CLS] pieces [SEP], cut to ``max_len`` ids."""
        ids = [self.cls_id]
        for w in self._basic_split(text):
            ids.extend(self._wordpiece(w))
            if len(ids) >= max_len - 1:
                break
        return ids[: max_len - 1] + [self.sep_id]

    def batch(self, texts: Sequence[str], max_len: int = 64):
        """(ids, mask), each (N, longest) int32, right-padded with [PAD]."""
        rows = [self.encode(t, max_len) for t in texts]
        t = max(len(r) for r in rows)
        input_ids = np.full((len(rows), t), self.pad_id, np.int32)
        mask = np.zeros((len(rows), t), np.int32)
        for i, r in enumerate(rows):
            input_ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return input_ids, mask


def strip_prefix(sd: Dict[str, torch.Tensor], marker: str = "embeddings.word_embeddings.weight") -> Dict[str, torch.Tensor]:
    """The BERT subtree of a state dict, whatever its wrapper prefix
    (``bert.``, ``encoder.``, ``0.auto_model.``)."""
    for k in sd:
        if k.endswith(marker):
            prefix = k[: -len(marker)]
            return {kk[len(prefix):]: v for kk, v in sd.items() if kk.startswith(prefix)}
    raise KeyError(f"no key ending with {marker!r} in checkpoint")


def bert_cfg_from_state(sd: Dict[str, torch.Tensor], n_heads: Optional[int] = None) -> BertConfig:
    """The ``BertConfig`` a state dict's shapes give; the head count, which
    the shapes do not hold, is ``n_heads`` or d_model / 64."""
    word = sd["embeddings.word_embeddings.weight"]
    n_layers = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.layer."))
    d = word.shape[1]
    return BertConfig(
        vocab_size=word.shape[0], d_model=d, n_layers=n_layers, n_heads=n_heads or max(1, d // 64),
        ffn_dim=sd["encoder.layer.0.intermediate.dense.weight"].shape[0],
        max_positions=sd["embeddings.position_embeddings.weight"].shape[0],
        type_vocab_size=sd["embeddings.token_type_embeddings.weight"].shape[0],
    )


def _load_trunk(sd: Dict[str, torch.Tensor], device, n_heads: Optional[int] = None) -> BertEncoder:
    sd = strip_prefix(sd)
    cfg = bert_cfg_from_state(sd, n_heads)
    enc = BertEncoder(cfg, device=device)
    enc.load_state_dict(convert_bert_torch_state(sd, cfg))
    return enc.eval()


class FenseScorer:
    """FENSE from local weights: SBERT similarity, with the fluency penalty
    when an echecker checkpoint is given. The models sit on ``device`` (the
    card unless the caller asks for the CPU)."""

    def __init__(self, sbert_path: str, echecker_path: Optional[str] = None, error_threshold: float = 0.9,
                 penalty: float = 0.9, max_len: int = 64, device="cuda"):
        from slam_llm_tpu_torch.pipeline.common import resolve_device
        from slam_llm_tpu_torch.utils.hf_loader import load_hf_state_dict, load_torch_checkpoint

        self.device = resolve_device(device)
        self.error_threshold, self.penalty, self.max_len = error_threshold, penalty, max_len
        if os.path.isdir(sbert_path):
            sd, root = load_hf_state_dict(sbert_path), sbert_path
        else:
            sd, root = load_torch_checkpoint(sbert_path), os.path.dirname(sbert_path)
        n_heads = None
        if os.path.isfile(os.path.join(root, "config.json")):
            with open(os.path.join(root, "config.json"), encoding="utf-8") as f:
                n_heads = json.load(f).get("num_attention_heads")
        self.tokenizer = WordPieceTokenizer(os.path.join(root, "vocab.txt"))
        self.sbert = _load_trunk(sd, self.device, n_heads)
        self.echecker = self.head = None
        if echecker_path:
            raw = load_torch_checkpoint(echecker_path)
            if isinstance(raw, dict) and "model_state_dict" in raw:
                raw = raw["model_state_dict"]
            w = next(raw[k] for k in raw if k.endswith(("clf.weight", "classifier.weight")))
            b = next(raw[k] for k in raw if k.endswith(("clf.bias", "classifier.bias")))
            self.echecker = _load_trunk(raw, self.device)
            self.head = (w.float().to(self.device), b.float().to(self.device))

    def _tokens(self, texts: Sequence[str]):
        ids, mask = self.tokenizer.batch(list(texts), self.max_len)
        return torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device)

    @torch.inference_mode()
    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """Masked mean-pooled, L2-normalized sentence embeddings (N, D)."""
        ids, mask = self._tokens(texts)
        h = self.sbert(ids, mask)
        m = mask[..., None].float()
        z = (h * m).sum(1) / m.sum(1).clamp_min(1e-9)
        return (z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(1e-12)).cpu().numpy()

    @torch.inference_mode()
    def fluency_errors(self, texts: Sequence[str]) -> List[bool]:
        """True where the echecker flags any error class above the threshold;
        without an echecker nothing is flagged (similarity-only FENSE)."""
        if self.echecker is None:
            return [False] * len(texts)
        ids, mask = self._tokens(texts)
        w, b = self.head
        probs = torch.sigmoid(self.echecker(ids, mask)[:, 0] @ w.T + b)
        return (probs > self.error_threshold).any(dim=-1).cpu().tolist()

    def score(self, candidates: List[str], references: List[List[str]]) -> float:
        from slam_llm_tpu_torch.utils.caption_metrics import fense

        return fense(candidates, references, self.embed, fluency_error_fn=self.fluency_errors, penalty=self.penalty)
