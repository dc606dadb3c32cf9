"""CTC-filtered hotword biasing (contextual ASR).

Counterpart of ``slam_llm_tpu/utils/hotword_filter.py``. Given a first-pass
(CTC) transcript and a large biasing-word list, it retrieves candidate
names through a character-bigram inverted index, scores each by its best
Levenshtein ratio against the transcript's word n-grams of the same word
count, and keeps the high scorers for the "The hotwords are ..." prompt
(the reference's ``hotwordsinfer_dataset.py``).

It runs offline, once per manifest, and writes the per-utterance
``hotwords`` field the speech dataset folds into the prompt: the command is
``examples/contextual_asr/filter_hotwords.py``. The ratio is
python-Levenshtein's: (|a| + |b| - indel distance) / (|a| + |b|), with the
insert / delete-only distance computed here.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Set


def build_ngram_index(names: Sequence[str], n: int = 2) -> Dict[str, Set[str]]:
    """Character n-gram inverted index over biasing names (reference :22-29)."""
    index: Dict[str, Set[str]] = {}
    for name in names:
        for i in range(len(name) - n + 1):
            index.setdefault(name[i : i + n].lower(), set()).add(name)
    return index


def find_candidate_names(
    sentence: str, ngram_index: Dict[str, Set[str]], n: int = 2
) -> Set[str]:
    """Names sharing at least one character n-gram with the sentence
    (reference :31-37)."""
    candidates: Set[str] = set()
    for i in range(len(sentence) - n + 1):
        candidates.update(ngram_index.get(sentence[i : i + n].lower(), ()))
    return candidates


def _indel_distance(a: str, b: str) -> int:
    """Levenshtein distance with substitutions forbidden (insert/delete only)
    — the distance underlying python-Levenshtein's ``ratio``. Equivalent to
    len(a)+len(b)-2*LCS(a,b); two-row DP."""
    if a == b:
        return 0
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            if ca == cb:
                cur.append(prev[j - 1])
            else:
                cur.append(1 + min(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


@lru_cache(maxsize=100000)
def levenshtein_ratio(a: str, b: str) -> float:
    """python-Levenshtein ``ratio`` parity: (|a|+|b|-indel)/(|a|+|b|)."""
    lensum = len(a) + len(b)
    if lensum == 0:
        return 1.0
    return (lensum - _indel_distance(a, b)) / lensum


def _word_ngrams(sentence: str, n: int) -> List[str]:
    words = sentence.split()
    return [" ".join(words[i : i + n]) for i in range(len(words) - n + 1)]


def calculate_similarity_score(
    name: str, sentence: str, length_tolerance: int = 3
) -> float:
    """Max Levenshtein ratio of ``name`` vs same-word-count n-grams of the
    sentence whose length is within ``length_tolerance`` chars (reference
    :47-57)."""
    n = len(name.split())
    best = 0.0
    for ngram in _word_ngrams(sentence, n):
        if abs(len(ngram) - len(name)) <= length_tolerance:
            best = max(best, levenshtein_ratio(name.lower(), ngram.lower()))
    return best


def score_candidates(candidates: Iterable[str], sentence: str) -> Dict[str, float]:
    return {c: calculate_similarity_score(c, sentence) for c in candidates}


def filter_hotwords(
    infer_sentence: str,
    biaswords: Sequence[str],
    common_words: Optional[Set[str]] = None,
    probability_threshold: float = 0.95,
    word_num: int = 15,
    ngram_index: Optional[Dict[str, Set[str]]] = None,
) -> List[str]:
    """One utterance's biasing-list filter (reference :185-201 'filter' path):
    drop common words from the transcript, retrieve bigram candidates, keep
    scores > threshold — or the top ``word_num`` if fewer clear the bar.

    Pass a prebuilt ``ngram_index`` when the biasing list is shared across
    utterances (the reference rebuilds it per item; this is the hot loop)."""
    sentence = infer_sentence.lower()
    if common_words:
        sentence = " ".join(w for w in sentence.split() if w not in common_words)
    index = ngram_index if ngram_index is not None else build_ngram_index(biaswords)
    candidates = find_candidate_names(sentence, index)
    scores = score_candidates(candidates, sentence)
    ranked = sorted(scores.items(), key=lambda kv: kv[1], reverse=True)
    keep = [(k, v) for k, v in ranked if v > probability_threshold]
    if len(keep) < word_num:
        keep = ranked[:word_num]
    return [k for k, _ in keep]
