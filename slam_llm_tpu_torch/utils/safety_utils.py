"""Content-safety checkers for inference outputs.

Counterpart of ``slam_llm_tpu/utils/safety_utils.py``.

Mirror of the reference's optional safety stack (inference/safety_utils.py:
AuditNLG / Salesforce classifier / Azure content-safety API). Those are
network/API dependent; here the always-available checker is a keyword/regex
screen with the same interface, and the external ones load lazily when their
packages are installed."""

from __future__ import annotations

import re
from typing import List, Tuple


class KeywordSafetyChecker:
    """Dependency-free screen: flags a configurable blocklist."""

    DEFAULT_PATTERNS = [
        r"\b(?:how\s+to\s+(?:build|make))\s+(?:a\s+)?(?:bomb|explosive)\b",
        r"\bchild\s+sexual\b",
    ]

    def __init__(self, patterns=None):
        self.patterns = [re.compile(p, re.I) for p in (patterns or self.DEFAULT_PATTERNS)]

    def __call__(self, text: str) -> Tuple[str, bool, str]:
        for p in self.patterns:
            if p.search(text):
                return "KeywordSafetyChecker", False, f"matched {p.pattern!r}"
        return "KeywordSafetyChecker", True, ""


class AuditNLGSafetyChecker:
    """Wraps auditnlg when installed (reference safety_utils.py:10-34)."""

    def __call__(self, text: str) -> Tuple[str, bool, str]:
        try:
            from auditnlg.safety.exam import safety_scores
        except ImportError:
            return "AuditNLGSafetyChecker", True, "auditnlg not installed (skipped)"
        data = [{"output": text}]
        result = safety_scores(data=data, method="sensitive_topics")
        scores = result[1]["all_scores"][0]
        is_safe = scores["pred_class"] == "none"
        return "AuditNLGSafetyChecker", is_safe, str(scores)


def get_safety_checkers(enable_audit: bool = False) -> List:
    checkers: List = [KeywordSafetyChecker()]
    if enable_audit:
        checkers.append(AuditNLGSafetyChecker())
    return checkers


def is_safe(text: str, checkers=None) -> Tuple[bool, List[Tuple[str, bool, str]]]:
    checkers = checkers or get_safety_checkers()
    reports = [c(text) for c in checkers]
    return all(ok for _, ok, _ in reports), reports
