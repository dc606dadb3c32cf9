"""CoT-ST scoring: split chained ``<transcript> <|lang|> <translation>``
outputs and report ASR WER and translation BLEU.

    python -m slam_llm_tpu_torch.tools.eval_werbleu --pred <decode_log>_pred --gt <decode_log>_gt
    python -m slam_llm_tpu_torch.tools.eval_werbleu --file <results.jsonl> [--task asr]

The port's counterpart of ``examples/st_covost2/eval_werbleu.py``, through
the port's own ``utils/{wer,textnorm,bleu}.py``, and printing the same lines:

* gt / response are split on the ``<|lang|>`` tag found in the gt; a gt
  without one is scored whole as a translation;
* WER: orthographic and ``basic_normalize``-normalized, rows whose
  normalized reference is empty dropped;
* BLEU: corpus BLEU, lowercased, 13a tokenization (CJK characters split
  for zh / ja targets).

Input: the reference's results jsonl (``{"gt", "response", "source"}`` rows)
through ``--file``, or the ``key\\ttext`` decode logs of
``pipeline.inference_batch`` through ``--pred`` / ``--gt``.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

from slam_llm_tpu_torch.utils.bleu import TOKENIZERS, corpus_bleu, tokenize_13a
from slam_llm_tpu_torch.utils.textnorm import basic_normalize
from slam_llm_tpu_torch.utils.wer import compute_wer_lists

_LANG_TAG = re.compile(r"<\|([a-zA-Z_]+)\|>")


def _read_log(path: str) -> dict:
    out = {}
    for line in Path(path).read_text().splitlines():
        if "\t" in line:
            key, text = line.split("\t", 1)
            out[key] = text
    return out


def read_pairs(args) -> Iterator[Tuple[str, str]]:
    """(gt, response) pairs."""
    if args.file:
        for line in Path(args.file).read_text().splitlines():
            if line.strip():
                row = json.loads(line)
                yield row["gt"], row["response"]
        return
    gt, pred = _read_log(args.gt), _read_log(args.pred)
    for key in gt:
        yield gt[key], pred.get(key, "")


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Print, and return, the WER line (when there are transcripts) and the
    BLEU line (``--task st`` with translations)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--file", help="reference-format results jsonl")
    ap.add_argument("--pred", help="decode log: {decode_log}_pred")
    ap.add_argument("--gt", help="decode log: {decode_log}_gt")
    ap.add_argument("--task", default="st", choices=["st", "asr"])
    args = ap.parse_args(argv)
    if not args.file and not (args.pred and args.gt):
        ap.error("need --file or --pred/--gt")

    resp_asr, resp_st, gt_asr, gt_st = [], [], [], []
    lang = None
    for gt, response in read_pairs(args):
        if args.task == "asr":
            gt_asr.append(gt)
            resp_asr.append(response)
            continue
        m = _LANG_TAG.search(gt)
        if not m:  # no CoT tag: the whole string is the translation
            gt_st.append(gt)
            resp_st.append(response)
            continue
        lang, tag = m.group(1), m.group(0)
        g1, g2 = (p.strip() for p in gt.split(tag, 1))
        rp = response.split(tag, 1)
        r1, r2 = (rp[0].strip(), rp[1].strip()) if len(rp) == 2 else (response, response)
        gt_asr.append(g1)
        gt_st.append(g2)
        resp_asr.append(r1)
        resp_st.append(r2)

    lines = []
    if gt_asr:
        wer_ortho = compute_wer_lists(gt_asr, resp_asr).wer
        norm = [(basic_normalize(p), basic_normalize(g)) for p, g in zip(resp_asr, gt_asr)]
        norm = [(p, g) for p, g in norm if g]
        wer_norm = compute_wer_lists([g for _, g in norm], [p for p, _ in norm]).wer if norm else float("nan")
        lines.append({"wer_ortho": wer_ortho, "wer": wer_norm})
    if args.task == "st" and gt_st:
        tok = TOKENIZERS.get((lang or "13a").split("_")[0], tokenize_13a)
        score, precisions, bp = corpus_bleu([r.lower() for r in resp_st], [[g.lower()] for g in gt_st], tokenize=tok)
        lines.append({
            "count": len(resp_st), "bleu": round(score, 2), "precisions": [round(p, 1) for p in precisions],
            "bp": round(bp, 3), "tokenize": "zh" if tok is not tokenize_13a else "13a",
        })
    for line in lines:
        print(json.dumps(line))
    return lines


if __name__ == "__main__":
    main(sys.argv[1:])
