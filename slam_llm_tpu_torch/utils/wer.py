"""WER with full alignment + per-utterance diff report.

Functional mirror of the reference's ``utils/compute_wer.py:38-197``: same
kaldi-style inputs (``key<tab>text`` per line), same aggregate lines
(``%WER .. [ w / n, i ins, d del, s sub ]``, ``%SER``), same per-utterance
ref/hyp/diff detail file — so existing eval tooling keeps working. The
alignment is a two-row list DP (in-row delete dependency makes the inner
loop inherently sequential; plain lists beat per-cell numpy scalar ops
severalfold). Counterpart of ``slam_llm_tpu/utils/wer.py``: score a decode
with ``compute_wer_files(f"{decode_log}_gt", f"{decode_log}_pred", detail_file)``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

OK, SUB, INS, DEL = 0, 1, 2, 3


def align(hyp: Sequence[str], ref: Sequence[str]) -> Tuple[Dict[str, int], List[Tuple[int, int, int]]]:
    """Levenshtein alignment: returns counts + backtrace path
    [(op, hyp_idx, ref_idx)]. Lowercases both sides like the reference."""
    hyp = [w.lower() for w in hyp]
    ref = [w.lower() for w in ref]
    lh, lr = len(hyp), len(ref)
    ops = [bytearray(lr + 1) for _ in range(lh + 1)]
    for j in range(1, lr + 1):
        ops[0][j] = DEL
    for i in range(1, lh + 1):
        ops[i][0] = INS
    prev = list(range(lr + 1))
    for i in range(1, lh + 1):
        cur = [i] + [0] * lr
        oi = ops[i]
        hw = hyp[i - 1]
        for j in range(1, lr + 1):
            match = hw == ref[j - 1]
            c_sub = prev[j - 1] + (0 if match else 1)
            c_ins = prev[j] + 1
            c_del = cur[j - 1] + 1
            # tie order: sub/ok, then ins, then del (matches the old form)
            if c_sub <= c_ins and c_sub <= c_del:
                cur[j] = c_sub
                oi[j] = OK if match else SUB
            elif c_ins <= c_del:
                cur[j] = c_ins
                oi[j] = INS
            else:
                cur[j] = c_del
                oi[j] = DEL
        prev = cur

    path = []
    i, j = lh, lr
    counts = {"cor": 0, "sub": 0, "ins": 0, "del": 0}
    while i > 0 or j > 0:
        op = ops[i][j]
        if i > 0 and j > 0 and op in (OK, SUB):
            path.append((int(op), i - 1, j - 1))
            counts["cor" if op == OK else "sub"] += 1
            i, j = i - 1, j - 1
        elif i > 0 and (j == 0 or op == INS):
            path.append((INS, i - 1, -1))
            counts["ins"] += 1
            i -= 1
        else:
            path.append((DEL, -1, j - 1))
            counts["del"] += 1
            j -= 1
    path.reverse()
    return counts, path


def diff_line(hyp: Sequence[str], ref: Sequence[str], path) -> str:
    out = []
    for op, hi, ri in path:
        if op == OK:
            out.append(hyp[hi].lower())
        elif op == SUB:
            out.append(f"({ref[ri].lower()}->{hyp[hi].lower()})")
        elif op == INS:
            out.append(f"(+{hyp[hi].lower()})")
        else:
            out.append(f"(-{ref[ri].lower()})")
    return " ".join(out)


@dataclass
class WerResult:
    wer: float = 0.0
    ser: float = 0.0
    words: int = 0
    errors: int = 0
    ins: int = 0
    dels: int = 0
    subs: int = 0
    sentences: int = 0
    wrong_sentences: int = 0

    def summary(self) -> str:
        return (
            f"%WER {self.wer} [ {self.errors} / {self.words}, {self.ins} ins, "
            f"{self.dels} del, {self.subs} sub ]\n"
            f"%SER {self.ser} [ {self.wrong_sentences} / {self.sentences} ]"
        )


def read_trn(path: str) -> Dict[str, List[str]]:
    """key<tab-or-space>words per line (the reference's decode-log format)."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split()
            if parts:
                out[parts[0]] = parts[1:]
    return out


def compute_wer_files(ref_file: str, hyp_file: str, detail_file: str = None) -> WerResult:
    """File-level WER matching the reference CLI (utils/compute_wer.py:38)."""
    refs, hyps = read_trn(ref_file), read_trn(hyp_file)
    res = WerResult()
    lines = []
    # score pairs present in BOTH (reference semantics), but report the
    # misses in both directions — an aborted decode must not silently score
    # as if the undecoded half never existed
    missing_from_hyp = sum(1 for k in refs if k not in hyps)
    extra_in_hyp = sum(1 for k in hyps if k not in refs)
    for key, ref in refs.items():
        if key not in hyps:
            continue
        hyp = hyps[key]
        counts, path = align(hyp, ref)
        wrong = counts["sub"] + counts["ins"] + counts["del"]
        res.words += len(ref)
        res.ins += counts["ins"]
        res.dels += counts["del"]
        res.subs += counts["sub"]
        res.errors += wrong
        res.sentences += 1
        if wrong:
            res.wrong_sentences += 1
        if detail_file:
            nref = max(len(ref), 1)
            lines.append(
                f"{key} wer {round(wrong * 100 / nref, 2)} [ {wrong} / {len(ref)}, "
                f"{counts['ins']} ins, {counts['del']} del, {counts['sub']} sub ]"
            )
            lines.append("ref:\t" + " ".join(w.lower() for w in ref))
            lines.append("hyp:\t" + " ".join(w.lower() for w in hyp))
            lines.append("diff:\t" + diff_line(hyp, ref, path))
    if res.words:
        res.wer = round(res.errors * 100 / res.words, 2)
    if res.sentences:
        res.ser = round(res.wrong_sentences * 100 / res.sentences, 2)
    if detail_file:
        with open(detail_file, "w", encoding="utf-8") as f:
            f.write("\n".join(lines))
            f.write("\n\n" + res.summary() + "\n")
            f.write(
                f"Scored {res.sentences} sentences, {missing_from_hyp} not "
                f"present in hyp, {extra_in_hyp} hyp keys not in ref.\n"
            )
    return res


def compute_wer_lists(refs: Sequence[str], hyps: Sequence[str]) -> WerResult:
    """In-memory WER over parallel lists of sentences."""
    res = WerResult()
    for ref_s, hyp_s in zip(refs, hyps):
        ref, hyp = ref_s.split(), hyp_s.split()
        counts, _ = align(hyp, ref)
        wrong = counts["sub"] + counts["ins"] + counts["del"]
        res.words += len(ref)
        res.ins += counts["ins"]
        res.dels += counts["del"]
        res.subs += counts["sub"]
        res.errors += wrong
        res.sentences += 1
        if wrong:
            res.wrong_sentences += 1
    if res.words:
        res.wer = round(res.errors * 100 / res.words, 2)
    if res.sentences:
        res.ser = round(res.wrong_sentences * 100 / res.sentences, 2)
    return res
