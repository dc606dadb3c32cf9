"""E-chat emotional-dialog dataset, the SEC recipe's dialog variant.

Counterpart of ``slam_llm_tpu/data/echat_dataset.py``. The manifest is a
TSV of dialogs, ``dialog_name\\t[{"wav", "emotion", "trans"}, ...]``, read
with ``json.loads`` and, for python-literal manifests, ``ast.literal_eval``
(never ``eval``). Consecutive turns pair up: turn i's wav -> turn i + 1's
``<|emotion|><|reply|>``, skipping a next turn whose emotion is ``xxx``. One
``data_path`` is split by position, 90 % train and 10 % validation; separate
train / val files are each their split. Items and collation are the speech
dataset's."""

from __future__ import annotations

import ast
import json
from typing import Any, Dict, List

from slam_llm_tpu_torch.data.speech_dataset import SpeechDatasetJsonl

ANSWER_TEMPLATE = "<|{}|><|{}|>"
DEFAULT_ECHAT_PROMPT = (
    "Please provide an emotional response based on the emotional speech you hear. "
    "Remember to format your answer as follows: <|EMOTION|><|REPLY|>. "
    "<|EMOTION|> is a standalone adjective. "
    "<|REPLY|> is a reply based on a the speech."
)


def parse_echat_manifest(path: str) -> List[Dict[str, Any]]:
    """Dialog TSV -> flat ``[{key, source, target, emotion}]`` records."""
    records: List[Dict[str, Any]] = []
    with open(path, encoding="utf-8") as fin:
        for line in fin:
            line = line.strip()
            if not line or "\t" not in line:
                continue
            dialog_name, dialog = line.split("\t", 1)
            try:
                turns = json.loads(dialog)
            except json.JSONDecodeError:
                turns = ast.literal_eval(dialog)
            for i in range(len(turns) - 1):
                a, b = turns[i], turns[i + 1]
                if "emotion" in a and "emotion" in b and b["emotion"] != "xxx":
                    records.append({"key": f"{dialog_name}_{i}", "source": a["wav"],
                                    "target": ANSWER_TEMPLATE.format(b["emotion"], b["trans"]),
                                    "emotion": b["emotion"]})
    return records


class EChatDataset(SpeechDatasetJsonl):
    """The speech dataset's items and collation over E-chat's turn pairs."""

    def __init__(self, dataset_config, tokenizer=None, split: str = "train"):
        super().__init__(dataset_config, tokenizer, split)
        self.prompt = getattr(dataset_config, "prompt", None) or DEFAULT_ECHAT_PROMPT

    def read_manifest(self, dataset_config, split: str) -> List[dict]:
        single = getattr(dataset_config, "data_path", None)
        path = single or (dataset_config.train_data_path if split == "train" else dataset_config.val_data_path)
        records = parse_echat_manifest(path)
        if not single:  # separate files: each is its split
            return records
        cut = int(len(records) * 0.9)
        return records[:cut] if split == "train" else records[cut:]


def get_echat_dataset(dataset_config, tokenizer, split: str) -> EChatDataset:
    return EChatDataset(dataset_config, tokenizer, split)
