"""Phase 5's training step of one checkout, so that two checkouts can be
compared in one session on one card.

    python slam_llm_tpu_torch/tools/bench_train_step.py --repo DIR [--torchrun] [--out FILE]   # on a GPU

Imports ``chip_smoke`` and ``slam_llm_tpu_torch`` from the checkout ``DIR``
(run the script by its path, not with ``-m``, so that the package comes from
``DIR``), builds its kernels and runs its ``asr_whisper_tinyllama.yaml``
training as phase 5 does: full width, random weights from the recipe's seed,
8 steps of 16 synthetic utterances through ``pipeline.finetune.main`` on one
card, the step time the mean of steps 3-8. With ``--torchrun`` (a checkout
that has phase 19) it then runs the same steps through phase 19's launch
(``torch.distributed.run --nproc_per_node=1``: NCCL, FSDP2 at world size 1).
Prints, and appends to ``FILE``, one JSON line: the card's name and power
limit, each run's step times in ms, their mean and the peak memory.

Run parent, change, change, parent in one call and compare within it.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", required=True, help="the checkout whose chip_smoke.py and package to run")
    ap.add_argument("--torchrun", action="store_true", help="also run phase 19's launch at world size 1")
    ap.add_argument("--out", default=None, help="a file to append the JSON line to")
    args = ap.parse_args()
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    import chip_smoke as cs

    smi = cs.setup()
    cs.build()
    tmp = Path(tempfile.mkdtemp(prefix="bench_train_step_"))
    extra = ("++train_config.save_model=false",)
    res, _, stats = cs._finetune(cs._train_cfg(tmp, cs.TRAIN_STEPS, *extra), "train")
    line = {"repo": str(repo), "card": smi, "one_device": {
        "step_ms": [1000 * s["seconds"] for s in res["steps"]], "mean_ms_steps_3_on": stats["step_ms"],
        "peak_gib": stats["peak_gib"], "losses": [s["loss"] for s in res["steps"]]}}
    del res
    if args.torchrun:
        train_args = cs._train_args(tmp, cs.TRAIN_STEPS, *extra, f"++train_config.output_dir={tmp / 'dist'}")
        got = cs._torchrun(1, {"run": ["asr"], "asr_args": train_args}, tmp)
        steps = got["asr"]["steps"]
        ms = [1000 * s["seconds"] for s in steps]
        line["torchrun_world_1"] = {"step_ms": ms, "mean_ms_steps_3_on": sum(ms[2:]) / len(ms[2:]),
                                    "peak_gib": got["asr"]["peak_gib"], "losses": [s["loss"] for s in steps],
                                    "plain_param_reads_checked": got["plain_params"]["checked"]}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
