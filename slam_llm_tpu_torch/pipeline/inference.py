"""Interactive inference REPL: wav path + prompt -> transcription.

Counterpart of ``slam_llm_tpu/pipeline/inference.py`` (reference
``pipeline/inference.py:40-79``), with ``--device`` like the other CLIs
(default ``cuda``; asking for CUDA without a GPU raises):

    python -m slam_llm_tpu_torch.pipeline.inference --config <yaml> \\
        ++model_config.llm_path=<hf dir> ++model_config.encoder_path=<hf dir> ++ckpt_path=<ckpt dir>

Each stdin line ``<wav_path> [prompt]`` prints its decoded text; an empty
line ends. The weights are materialized once, before the first line (the
reference waits for the first batch only because flax's init needs one).
"""

from __future__ import annotations

import sys
from typing import List, Optional

from slam_llm_tpu_torch.config import RunConfig, load_run_config
from slam_llm_tpu_torch.data.speech_dataset import DEFAULT_PROMPT
from slam_llm_tpu_torch.inference.generate import Generator, strip_after_eos
from slam_llm_tpu_torch.pipeline.common import encode_one, materialize_params, parse_device, resolve_device
from slam_llm_tpu_torch.pipeline.inference_batch import generation_config
from slam_llm_tpu_torch.registry import get_custom_model_factory
from slam_llm_tpu_torch.utils.logging_utils import setup_logger


def main(cfg: RunConfig, device="cuda", lines=None, out=None) -> List[str]:
    """Decode every ``<wav_path> [prompt]`` line of ``lines`` (stdin by
    default) up to the first empty one, printing each text to ``out``
    (stdout by default); returns the texts."""
    dev = resolve_device(device)
    setup_logger("slam_llm_tpu_torch", log_file=cfg.log_config.log_file)
    lines = sys.stdin if lines is None else lines
    out = sys.stdout if out is None else out
    cfg.dataset_config.inference_mode = True
    # no dataset in interactive mode: resolve the model factory directly
    model, tokenizer = get_custom_model_factory(cfg.model_config)(cfg.train_config, cfg.model_config, device=dev)
    materialize_params(model.eval(), cfg)
    gen = Generator(model, generation_config(cfg, tokenizer))
    texts = []
    print("Enter: <wav_path> [prompt]  (empty line to exit)", file=out, flush=True)
    for line in lines:
        line = line.strip()
        if not line:
            break
        parts = line.split(maxsplit=1)
        prompt = parts[1] if len(parts) > 1 else (cfg.dataset_config.prompt or DEFAULT_PROMPT)
        batch = encode_one(parts[0], prompt, tokenizer, cfg.dataset_config,
                           ds_rate=cfg.model_config.encoder_projector_ds_rate)
        tokens = strip_after_eos(gen.generate(batch), tokenizer.eos_token_id, tokenizer.pad_token_id)
        texts.append(tokenizer.decode(tokens[0]))
        print(texts[-1], file=out, flush=True)
    return texts


def main_cli(argv: Optional[List[str]] = None):
    argv, device = parse_device(list(sys.argv[1:] if argv is None else argv))
    return main(load_run_config(argv), device=device)


if __name__ == "__main__":
    main_cli()
