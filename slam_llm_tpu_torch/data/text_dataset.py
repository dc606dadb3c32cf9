"""Text-instruction dataset: the text-only fine-tune of the LLM.

Counterpart of ``slam_llm_tpu/data/text_dataset.py``. jsonl rows are
``{key, instruct | source_text, target}``; no audio is read. An item is

  prompt  = PROMPT_TEMPLATE.format(prompt) + instruct.strip() + "\\n"
  sample  = tokens(prompt + target) + [eos]
  labels  = [-100 over the prompt's tokens, the rest of the sample]

and a batch pads every row to the smallest ``text_buckets`` entry (default
64 / 128 / 192 / 256, doubled past the last) that holds the longest one:
on the right for training, on the left in inference, where the batch also
carries the rows' ``keys`` and ``targets``. Its ``modality_mask`` is all
zero and it has no ``audio_mel``: ``SLAMModel`` then runs the LLM alone (the
``encoder_name: null`` route).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from slam_llm_tpu_torch.data.speech_dataset import IGNORE_INDEX, PROMPT_TEMPLATE, SpeechDatasetJsonl, bucketize


class TextDatasetJsonl(SpeechDatasetJsonl):
    def __init__(self, dataset_config, tokenizer=None, split: str = "train"):
        dataset_config.input_type = "mel"
        super().__init__(dataset_config, tokenizer, split)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        item = self.data_list[index]
        target = item.get("target")
        key = item.get("key")
        instruct = item.get("instruct") or item.get("source_text") or ""
        prompt = PROMPT_TEMPLATE.format(self.prompt) + instruct.strip() + "\n"
        prompt_ids = self.tokenizer.encode(prompt)
        prompt_length = len(prompt_ids)
        common = {"audio_mel": None, "audio_length": 0, "prompt_length": prompt_length, "key": key, "target": target}
        if self.inference_mode:
            ids = np.asarray(prompt_ids, np.int64)
            return {"input_ids": ids, "attention_mask": np.ones_like(ids, np.int32), **common}
        ids = np.asarray(list(self.tokenizer.encode(prompt + str(target))) + [self.tokenizer.eos_token_id], np.int64)
        labels = ids.copy()
        labels[:prompt_length] = IGNORE_INDEX
        return {"input_ids": ids, "labels": labels, "attention_mask": np.ones_like(ids, np.int32), **common}

    def collator(self, samples: List[Dict[str, Any]]) -> Dict[str, Any]:
        text_buckets = list(getattr(self.config, "text_buckets", [64, 128, 192, 256]))
        total = bucketize(max(len(s["input_ids"]) for s in samples), text_buckets)
        b = len(samples)
        input_ids = np.full((b, total), self.tokenizer.pad_token_id, np.int64)
        attention_mask = np.zeros((b, total), np.int32)
        labels = np.full((b, total), IGNORE_INDEX, np.int64)
        for i, s in enumerate(samples):
            n = len(s["input_ids"])
            left = total - n if self.inference_mode else 0
            input_ids[i, left:left + n] = s["input_ids"]
            attention_mask[i, left:left + n] = 1
            if "labels" in s:
                labels[i, left:left + n] = s["labels"]
        out = {"input_ids": input_ids, "attention_mask": attention_mask,
               "modality_mask": np.zeros((b, total), np.int32)}
        if not self.inference_mode:
            out["labels"] = labels
        else:
            out["keys"] = [s["key"] for s in samples]
            out["targets"] = [s["target"] for s in samples]
        return out


def get_text_dataset(dataset_config, tokenizer, split: str) -> TextDatasetJsonl:
    return TextDatasetJsonl(dataset_config, tokenizer, split)
