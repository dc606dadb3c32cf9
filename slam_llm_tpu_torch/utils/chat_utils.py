"""Multi-turn chat formatting (reference inference/chat_utils.py).

Counterpart of ``slam_llm_tpu/utils/chat_utils.py``.

Reads dialogs as json lists of {"role", "content"} turns and renders them
with llama-2-chat or vicuna templates for the text-dialog inference path."""

from __future__ import annotations

import json
from typing import Dict, List

B_INST, E_INST = "[INST]", "[/INST]"
B_SYS, E_SYS = "<<SYS>>\n", "\n<</SYS>>\n\n"


def read_dialogs_from_file(path: str) -> List[List[Dict[str, str]]]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def format_llama2_chat(dialog: List[Dict[str, str]]) -> str:
    """llama-2-chat prompt format (system folded into the first user turn)."""
    if dialog and dialog[0]["role"] == "system":
        sys_msg = dialog[0]["content"]
        dialog = dialog[1:]
        if dialog:
            dialog = [
                {"role": dialog[0]["role"],
                 "content": B_SYS + sys_msg + E_SYS + dialog[0]["content"]}
            ] + dialog[1:]
    parts = []
    for i in range(0, len(dialog), 2):
        user = dialog[i]["content"]
        parts.append(f"{B_INST} {user.strip()} {E_INST}")
        if i + 1 < len(dialog):
            parts.append(f" {dialog[i + 1]['content'].strip()} ")
    return "".join(parts)


def format_vicuna_chat(dialog: List[Dict[str, str]]) -> str:
    lines = []
    for turn in dialog:
        if turn["role"] == "system":
            lines.append(turn["content"].strip())
        elif turn["role"] == "user":
            lines.append(f"USER: {turn['content'].strip()}")
        else:
            lines.append(f"ASSISTANT: {turn['content'].strip()}")
    lines.append("ASSISTANT:")
    return "\n".join(lines)
