"""Caption metrics for AAC recipes: BLEU-n, ROUGE-L, CIDEr-D, METEOR-lite.

Counterpart of ``slam_llm_tpu/utils/caption_metrics.py`` (pure Python, held
against it by ``tests/test_torch_host.py``). Score a decode's logs with

    python -m slam_llm_tpu_torch.utils.caption_metrics <decode_log>_gt <decode_log>_pred

The reference shells out to the ``aac-metrics`` pip package
(reference utils/compute_aac_metrics.py), which wraps the original
caption-eval implementations. These are from-scratch implementations of the
same published formulas:

  * BLEU-n  (Papineni et al. 2002, corpus-level, brevity penalty);
  * ROUGE-L (Lin 2004, F-beta with beta=1.2 as in caption-eval);
  * CIDEr-D (Vedantam et al. 2015: tf-idf n-gram cosine, length gaussian
    penalty sigma=6, n=1..4, *10 scaling);
  * METEOR-lite: unigram alignment F-mean (alpha=0.9) with fragmentation
    penalty (gamma=0.5, beta=3) over exact + suffix-stem + synonym-table
    matches — the full METEOR's WordNet synonym/paraphrase stages use data
    files not available offline, so scores are close-but-not-identical;
  * SPICE via the in-tree scene-graph scorer (utils/spice.py), making
    SPIDEr = (CIDEr + SPICE)/2 computable offline.
"""

from __future__ import annotations

import json
import math
import sys
from collections import Counter
from typing import Dict, List, Sequence, Tuple


def _tokenize(s: str) -> List[str]:
    out = []
    word = []
    for ch in s.lower():
        if ch.isalnum() or ch == "'":
            word.append(ch)
        else:
            if word:
                out.append("".join(word))
                word = []
    if word:
        out.append("".join(word))
    return out


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------


def bleu(candidates: List[str], references: List[List[str]], max_n: int = 4) -> List[float]:
    """Corpus-level BLEU-1..max_n with standard brevity penalty."""
    clipped = [0] * max_n
    totals = [0] * max_n
    cand_len, ref_len = 0, 0
    for cand, refs in zip(candidates, references):
        c = _tokenize(cand)
        rs = [_tokenize(r) for r in refs]
        cand_len += len(c)
        ref_len += min((abs(len(r) - len(c)), len(r)) for r in rs)[1]
        for n in range(1, max_n + 1):
            cgrams = _ngrams(c, n)
            max_ref = Counter()
            for r in rs:
                for g, cnt in _ngrams(r, n).items():
                    max_ref[g] = max(max_ref[g], cnt)
            clipped[n - 1] += sum(min(cnt, max_ref[g]) for g, cnt in cgrams.items())
            totals[n - 1] += max(sum(cgrams.values()), 0)
    bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len / max(cand_len, 1))
    scores = []
    log_sum = 0.0
    for n in range(1, max_n + 1):
        p = clipped[n - 1] / totals[n - 1] if totals[n - 1] else 0.0
        log_sum += math.log(max(p, 1e-12))
        scores.append(bp * math.exp(log_sum / n))
    return scores  # [BLEU-1, ..., BLEU-4]


# ---------------------------------------------------------------------------
# ROUGE-L
# ---------------------------------------------------------------------------


def _lcs(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_l(candidates: List[str], references: List[List[str]], beta: float = 1.2) -> float:
    total = 0.0
    for cand, refs in zip(candidates, references):
        c = _tokenize(cand)
        best = 0.0
        for r in refs:
            rt = _tokenize(r)
            lcs = _lcs(c, rt)
            if lcs == 0:
                continue
            prec = lcs / len(c)
            rec = lcs / len(rt)
            score = ((1 + beta**2) * prec * rec) / (rec + beta**2 * prec)
            best = max(best, score)
        total += best
    return total / max(len(candidates), 1)


# ---------------------------------------------------------------------------
# CIDEr-D
# ---------------------------------------------------------------------------


def cider_d(
    candidates: List[str], references: List[List[str]], n_max: int = 4, sigma: float = 6.0
) -> float:
    """CIDEr-D: tf-idf weighted n-gram cosine with length penalty, x10."""
    # document frequencies over reference sets
    doc_freq: List[Counter] = [Counter() for _ in range(n_max)]
    ref_tokens = [[_tokenize(r) for r in refs] for refs in references]
    cand_tokens = [_tokenize(c) for c in candidates]
    for refs in ref_tokens:
        for n in range(n_max):
            seen = set()
            for r in refs:
                seen.update(_ngrams(r, n + 1).keys())
            for g in seen:
                doc_freq[n][g] += 1
    n_docs = max(len(references), 1)

    def tfidf(grams: Counter, n: int) -> Tuple[Dict, float]:
        # RAW counts * idf (pycocoevalcap cider_d.py semantics): min-clipping
        # is not invariant under per-vector scaling, so normalizing by the
        # total n-gram count here would change scores vs the reference scorer
        vec = {}
        norm = 0.0
        for g, cnt in grams.items():
            idf = math.log(max(n_docs, 1)) - math.log(max(doc_freq[n][g], 1))
            w = float(cnt) * idf
            vec[g] = w
            norm += w * w
        return vec, math.sqrt(norm)

    total_score = 0.0
    for c, refs in zip(cand_tokens, ref_tokens):
        score_n = 0.0
        for n in range(n_max):
            c_vec, c_norm = tfidf(_ngrams(c, n + 1), n)
            s = 0.0
            for r in refs:
                r_vec, r_norm = tfidf(_ngrams(r, n + 1), n)
                # clipped dot product (CIDEr-D)
                dot = sum(min(w, r_vec.get(g, 0.0)) * r_vec.get(g, 0.0) for g, w in c_vec.items())
                delta = len(c) - len(r)
                penalty = math.exp(-(delta**2) / (2 * sigma**2))
                if c_norm > 0 and r_norm > 0:
                    s += penalty * dot / (c_norm * r_norm)
            score_n += s / max(len(refs), 1)
        total_score += 10.0 * score_n / n_max
    return total_score / max(len(candidates), 1)


# ---------------------------------------------------------------------------
# METEOR-lite
# ---------------------------------------------------------------------------


def _stem(w: str) -> str:
    for suf in ("ing", "ed", "es", "s"):
        if len(w) > len(suf) + 2 and w.endswith(suf):
            return w[: -len(suf)]
    return w


def meteor_lite(
    candidates: List[str], references: List[List[str]],
    alpha: float = 0.9, beta: float = 3.0, gamma: float = 0.5,
) -> float:
    total = 0.0
    for cand, refs in zip(candidates, references):
        c = _tokenize(cand)
        best = 0.0
        for ref in refs:
            r = _tokenize(ref)
            # greedy one-to-one alignment, METEOR module order: exact,
            # stem, synonym. The synonym module (utils/spice.py's table
            # standing in for WordNet) compares LEMMAS, so inflected forms
            # reach their class ("speaking" ~ "talks"); the lemma comparison
            # itself also catches doubling-stems the suffix stemmer misses
            # ("dripping" ~ "drips"). Residual delta vs nltk's METEOR is
            # quantified in tests/test_meteor_delta.py.
            from slam_llm_tpu_torch.utils.spice import _match as _syn_match
            from slam_llm_tpu_torch.utils.spice import lemma as _lemma

            def _exact(w, rw):
                return w == rw

            def _stem_eq(w, rw):
                return _stem(w) == _stem(rw)

            def _syn_eq(w, rw):
                lw, lr = _lemma(w), _lemma(rw)
                return lw == lr or _syn_match(lw, lr)

            matches = []  # (c_idx, r_idx)
            used_r = set()
            for same in (_exact, _stem_eq, _syn_eq):
                for i, w in enumerate(c):
                    if any(m[0] == i for m in matches):
                        continue
                    for j, rw in enumerate(r):
                        if j in used_r:
                            continue
                        if same(w, rw):
                            matches.append((i, j))
                            used_r.add(j)
                            break
            m = len(matches)
            if m == 0:
                continue
            prec = m / len(c)
            rec = m / len(r)
            f_mean = prec * rec / (alpha * prec + (1 - alpha) * rec)
            # fragmentation: count chunks of contiguous aligned words
            matches.sort()
            chunks = 1
            for (i1, j1), (i2, j2) in zip(matches, matches[1:]):
                if not (i2 == i1 + 1 and j2 == j1 + 1):
                    chunks += 1
            frag = chunks / m
            score = f_mean * (1 - gamma * frag**beta)
            best = max(best, score)
        total += best
    return total / max(len(candidates), 1)


# ---------------------------------------------------------------------------
# aggregate + CLI (decode-log interface)
# ---------------------------------------------------------------------------


def fense(
    candidates: List[str],
    references: List[List[str]],
    embed_fn,
    fluency_error_fn=None,
    penalty: float = 0.9,
) -> float:
    """FENSE (Zhou et al. 2022): sentence-embedding cosine similarity between
    candidate and references, max over references, with a fluency-error
    penalty. The published scorer uses an SBERT encoder + a trained
    error detector — both PLUG IN here:

      * ``embed_fn(texts) -> (N, D)`` sentence embeddings (e.g. our BERT
        tower with a converted sentence-transformers checkpoint, mean-pooled
        + normalized);
      * ``fluency_error_fn(texts) -> [bool]`` flags disfluent candidates
        (optional; flagged scores are multiplied by ``1 - penalty``).
    """
    import numpy as np

    cand_z = np.asarray(embed_fn(candidates))
    scores = []
    flat_refs = [r for rs in references for r in rs]
    ref_z = np.asarray(embed_fn(flat_refs))
    errors = fluency_error_fn(candidates) if fluency_error_fn else [False] * len(candidates)
    i = 0
    for c in range(len(candidates)):
        n = len(references[c])
        sims = ref_z[i : i + n] @ cand_z[c]
        i += n
        s = float(sims.max())
        if errors[c]:
            s *= 1.0 - penalty
        scores.append(s)
    return float(np.mean(scores)) if scores else 0.0


def compute_caption_metrics(
    candidates: List[str],
    references: List[List[str]],
    spice_fn=None,
    fense_embed_fn=None,
    fense_fluency_fn=None,
) -> Dict[str, float]:
    """Standard AAC metric bundle.

    SPICE defaults to the in-tree scene-graph scorer (utils/spice.py — the
    Java/CoreNLP/WordNet stack rebuilt offline); pass
    ``spice_fn(candidates, references) -> float`` to substitute an external
    scorer. SPIDEr = (CIDEr + SPICE)/2, the headline AAC metric
    (reference examples/slam_aac/README.md:24-25). FENSE runs when an
    embedding callable is supplied (see ``fense``)."""
    b = bleu(candidates, references)
    cider = cider_d(candidates, references)
    out = {
        "bleu_1": round(b[0], 4),
        "bleu_4": round(b[3], 4),
        "rouge_l": round(rouge_l(candidates, references), 4),
        "meteor": round(meteor_lite(candidates, references), 4),
        "cider": round(cider, 4),
    }
    if spice_fn is None:
        from slam_llm_tpu_torch.utils.spice import spice as spice_fn
    spice = float(spice_fn(candidates, references))
    out["spice"] = round(spice, 4)
    out["spider"] = round((cider + spice) / 2, 4)
    if fense_embed_fn is not None:
        out["fense"] = round(
            fense(candidates, references, fense_embed_fn, fense_fluency_fn), 4
        )
    return out


def _read_log(path: str) -> Dict[str, List[str]]:
    """key -> ALL captions for that key (AAC gt logs carry multiple
    references per clip — Clotho has 5; collapsing to the last line would
    score against one arbitrary reference)."""
    out: Dict[str, List[str]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t", 1)
            if len(parts) == 1:
                parts = line.strip().split(maxsplit=1)
            if parts:
                out.setdefault(parts[0], []).append(parts[1] if len(parts) > 1 else "")
    return out


def main(gt_path: str, pred_path: str) -> Dict[str, float]:
    gts = _read_log(gt_path)
    preds = _read_log(pred_path)
    keys = [k for k in preds if k in gts]
    cands = [preds[k][-1] for k in keys]
    refs = [gts[k] for k in keys]
    metrics = compute_caption_metrics(cands, refs)
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
