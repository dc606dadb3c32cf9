"""Perplexity of decode outputs under a pretrained causal LM.

Counterpart of ``slam_llm_tpu/utils/ppl.py`` (the reference's
``utils/compute_ppl.py``): scores a decode log (``key<TAB>text`` lines)
under an HF llama-family checkpoint read into the port's ``CausalLM``
(``utils.hf_loader``) with the port's tokenizer. Each text is one causal
forward without a KV cache, which on the card runs K1 with the RoPE fused.

    python -m slam_llm_tpu_torch.utils.ppl <decode log> --llm <hf dir> \\
        [--llm-name tinyllama-1.1b] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import math
from typing import List, Tuple

import numpy as np
import torch


@torch.no_grad()
def ppl_of_texts(model, tokenizer, texts: List[str], max_len: int = 512) -> Tuple[List[float], float]:
    """Each text's perplexity (its mean next-token NLL, exponentiated; nan
    for a text of fewer than two tokens) and the corpus's (all NLLs over all
    predicted tokens). ``model`` is a ``CausalLM``; the text's first
    ``max_len`` tokens are scored."""
    device = next(model.parameters()).device
    nlls, counts = [], []
    for text in texts:
        ids = tokenizer.encode(text)[:max_len]
        if len(ids) < 2:
            nlls.append(0.0)
            counts.append(0)
            continue
        arr = torch.as_tensor(np.asarray(ids, np.int64)[None], device=device)
        logits = model(model.embed(arr), torch.ones_like(arr, dtype=torch.int32))
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        nll = -logp.gather(-1, arr[:, 1:, None])[..., 0]
        nlls.append(float(nll.sum()))
        counts.append(int(arr.shape[1] - 1))
    per_text = [math.exp(n / c) if c else float("nan") for n, c in zip(nlls, counts)]
    return per_text, math.exp(sum(nlls) / max(sum(counts), 1))


LLM_PRESETS = ("tinyllama-1.1b", "vicuna-7b", "qwen2-7b", "tiny-test")


def load_llm(llm_path: str, llm_name: str, device="cuda"):
    """A ``CausalLM`` of the ``llm_name`` preset on ``device`` holding the HF
    checkpoint of ``llm_path`` (bf16 compute, as the reference), and its
    tokenizer. ``convert_llama`` maps every tensor of the model (it has no
    LoRA; a checkpoint missing one raises there), so no random init is
    drawn first."""
    from slam_llm_tpu_torch.data.tokenizer import load_tokenizer
    from slam_llm_tpu_torch.models.llm import CausalLM, LLMConfig
    from slam_llm_tpu_torch.pipeline.common import resolve_device
    from slam_llm_tpu_torch.utils.hf_loader import convert_llama, load_hf_state_dict, overlay_

    presets = dict(zip(LLM_PRESETS, (LLMConfig.tinyllama_1_1b, LLMConfig.vicuna_7b, LLMConfig.qwen2_7b,
                                     LLMConfig.tiny_test)))
    cfg = presets[llm_name]()
    model = CausalLM(cfg, resolve_device(device))
    overlay_(model, convert_llama(load_hf_state_dict(llm_path), cfg))
    return model.eval(), load_tokenizer(llm_path)


def read_decode_log(path: str) -> List[str]:
    """The texts of a ``key<TAB>text`` decode log (lines without a tab skipped)."""
    texts = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("\t", 1)
            if len(parts) == 2:
                texts.append(parts[1])
    return texts


def main(argv=None) -> float:
    """CLI: a decode log's fluency under a REAL pretrained LM (``--llm``, an
    HF directory: under random weights the score is noise). Prints
    ``{"corpus_ppl", "n"}`` and returns the corpus perplexity."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("path", help="decode log (key<TAB>text per line)")
    ap.add_argument("--llm", required=True, help="HF llama-family checkpoint dir")
    ap.add_argument("--llm-name", default="tinyllama-1.1b", choices=LLM_PRESETS,
                    help="LLMConfig preset matching the checkpoint")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    model, tok = load_llm(args.llm, args.llm_name, args.device)
    texts = read_decode_log(args.path)
    _, total = ppl_of_texts(model, tok, texts)
    print(json.dumps({"corpus_ppl": round(total, 3), "n": len(texts)}))
    return total


if __name__ == "__main__":
    main()
