"""DRCap: zero-shot audio captioning by CLAP projection decoding and retrieval.

Counterpart of ``slam_llm_tpu/utils/drcap.py`` (the reference's
``examples/drcap_zeroshot_aac``). The captioner trains on text alone: the
CLAP text latent of each caption is its one-frame "audio" feature. At
decode the CLAP audio latent is projected onto a support store of caption
latents (a softmax-weighted mix, closing the modality gap), and the top-k
most similar captions go into the prompt.

* ``projection_decode``: z -> softmax(z S^T / temp) S;
* ``retrieve_topk``: the k most similar captions (``exclude_self`` skips a
  caption identical to the query, cosine 1);
* ``encode_captions``: a caption store through the CLAP text tower;
* ``augment_manifest_with_rag``: ``similar_captions`` added to each jsonl
  row, which the speech dataset folds into the prompt;
* ``save_support`` / ``load_support``: the store as an ``.npz`` in the JAX
  package's layout (``captions``, ``embeds``), so either package reads the
  other's;
* ``LatentCaptionDataset``: a speech dataset's text items with one latent
  each, collated into the batch the model takes: ``audio_mel`` (B, 1, D) f32
  and ``audio_mel_mask`` ones. Neither package carries a latent from a
  manifest (a ``.npy`` source becomes a log-mel there), so the latents are
  given beside the manifest.
"""

from __future__ import annotations

import json
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch


def _numpy(z) -> np.ndarray:
    return z.detach().float().cpu().numpy() if torch.is_tensor(z) else np.asarray(z)


def projection_decode(z: np.ndarray, support: np.ndarray, temp: float) -> np.ndarray:
    """(B, D) latents -> their projection onto the support store, (B, D)."""
    z, support = np.asarray(z), np.asarray(support)
    sim = z @ support.T / temp
    w = np.exp(sim - sim.max(axis=1, keepdims=True))
    return (w / w.sum(axis=1, keepdims=True)) @ support


def retrieve_topk(z: np.ndarray, support: np.ndarray, captions: Sequence[str], k: int = 3,
                  exclude_self: bool = False) -> List[List[str]]:
    """The k captions most similar to each latent, most similar first."""
    sim = np.asarray(z) @ np.asarray(support).T  # (B, N)
    out = []
    for i in range(sim.shape[0]):
        picks = []
        for j in np.argsort(-sim[i]):
            if exclude_self and np.isclose(sim[i, j], 1.0, atol=1e-5):
                continue
            picks.append(captions[int(j)])
            if len(picks) == k:
                break
        out.append(picks)
    return out


def encode_captions(captions: Sequence[str], clap_apply: Callable, tokenizer, max_text_len: int = 64,
                    batch_size: int = 64) -> np.ndarray:
    """(N, D) CLAP text latents of ``captions``, ``batch_size`` at a time:
    ``clap_apply(ids, mask)`` takes a ``tokenizer.batch`` pair (numpy) and
    returns the normalized (B, D) latents (an array or a tensor)."""
    outs = []
    for i in range(0, len(captions), batch_size):
        ids, mask = tokenizer.batch(list(captions[i: i + batch_size]), max_text_len)
        outs.append(_numpy(clap_apply(ids, mask)))
    return np.concatenate(outs, axis=0)


def augment_manifest_with_rag(manifest_in: str, manifest_out: str, support_captions: Sequence[str],
                              support_embeds: np.ndarray, embed_fn: Callable[[Sequence[str]], np.ndarray], k: int = 3,
                              batch_size: int = 64) -> int:
    """Each row of ``manifest_in`` with ``similar_captions``: the k support
    captions most similar to its target's latent, itself excluded, written
    to ``manifest_out``. Returns the row count."""
    rows = []
    with open(manifest_in, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                rows.append(json.loads(line))
    targets = [str(r.get("target", r.get("text", ""))) for r in rows]
    with open(manifest_out, "w", encoding="utf-8") as out:
        for i in range(0, len(rows), batch_size):
            z = _numpy(embed_fn(targets[i: i + batch_size]))
            sims = retrieve_topk(z, support_embeds, support_captions, k=k, exclude_self=True)
            for row, sc in zip(rows[i: i + batch_size], sims):
                row["similar_captions"] = sc
                out.write(json.dumps(row) + "\n")
    return len(rows)


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"  # np.savez appends .npz


def save_support(path: str, captions: Sequence[str], embeds: np.ndarray) -> None:
    np.savez(_npz_path(path), captions=np.asarray(list(captions), dtype=object), embeds=embeds)


def load_support(path: str) -> Tuple[List[str], np.ndarray]:
    d = np.load(_npz_path(path), allow_pickle=True)  # a store this package or the JAX package wrote
    return [str(c) for c in d["captions"]], np.asarray(d["embeds"], np.float32)


class LatentCaptionDataset:
    """``dataset``'s items, item i with ``latents[i]``; ``collator`` is the
    dataset's text collation plus ``audio_mel`` = the latents as (B, 1, D)
    f32 frames and ``audio_mel_mask`` = ones, the batch an encoder-less
    ``SLAMModel`` projects and splices (one audio slot a row:
    ``fix_length_audio: 1``)."""

    def __init__(self, dataset, latents: np.ndarray):
        if len(latents) != len(dataset):
            raise ValueError(f"{len(latents)} latents for {len(dataset)} rows")
        self.dataset, self.latents = dataset, np.asarray(latents, np.float32)

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, i: int) -> dict:
        return {**self.dataset[i], "latent": self.latents[i]}

    def sort_key(self, i: int) -> int:
        return self.dataset.sort_key(i)

    def collator(self, samples: List[dict]) -> dict:
        out = self.dataset.collate_text(samples)
        out["audio_mel"] = np.stack([s["latent"] for s in samples])[:, None]
        out["audio_mel_mask"] = np.ones((len(samples), 1), np.int32)
        return out
