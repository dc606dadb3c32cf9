"""Building a sharded model straight into its shards, on the CPU with gloo.

Under a mesh ``pipeline.common.build_model_and_data`` builds the model on
``meta`` and ``materialize_params`` fills each rank's shards one module at a
time (``materialize_sharded``). Worker processes run this file as a script
through ``test_torch_distributed``'s launcher (``_Group``: torchrun's
environment, ``PROC_TIMEOUT`` a worker, ``DIST_TIMEOUT`` a collective); each
rank builds the tiny recipe both ways on its own mesh: sharded, and whole
(the one-process build, prepared as the trainer prepares it, then sharded
by ``parallel.shard_params`` as before), and every rank writes its result.
The cases: ``fsdp=2`` and ``tp=2`` with the int8 base (its ``int8_rot``
pair and transpose, its scales) and the int8 CE head, over the seeded init
and an HF whisper encoder that the test writes; ``tp=2`` with the bf16 base
and ``bwd_pretranspose`` (``kernel_t``); and ``fsdp=2`` with the trainable
checkpoint of a one-process run (``ckpt_path``). Each rank's every local
part equals the whole build's bit for bit, and the model is on ``meta`` with
no tensor allocated before it is materialized.
"""

import os
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
WORLD = 2


def _parts(model):
    """Every tensor's local part (int8 through the carrier's bytes) and the
    names of the trainable ones."""
    from slam_llm_tpu_torch.parallel.sharding import INT8_CARRIER, local_part

    out = {}
    for name, t in [*model.named_parameters(), *model.named_buffers()]:
        local = local_part(t.detach())
        out[name] = (local.view(torch.int8) if local.dtype == INT8_CARRIER else local).clone()
    return out, sorted(n for n, p in model.named_parameters() if p.requires_grad)


def _build_job(job):
    import torch.distributed as dist

    from slam_llm_tpu_torch.parallel.sharding import make_mesh, shard_params
    from slam_llm_tpu_torch.pipeline.common import build_model_and_data, materialize_params, on_meta
    from slam_llm_tpu_torch.train.state import derives_int8, prepare_params
    from slam_llm_tpu_torch.ops.quant import quantize_base_params

    cfg, tc = job["cfg"], job["cfg"].train_config
    mesh = make_mesh(dp=1, fsdp=job["fsdp"], tp=job["tp"], device_type="cpu")
    model, _, _ = build_model_and_data(cfg, device="cpu", mesh=mesh)
    tensors = [*model.parameters(), *model.buffers()]
    all_meta = bool(tensors) and all(t.is_meta for t in tensors) and on_meta(model)
    kept = sum(v is not None for m in model.modules() for v in getattr(m, "construction_values", {}).values())
    materialize_params(model, cfg, mesh=mesh, device="cpu", train=True)
    got, got_train = _parts(model)
    still_meta = [n for n, t in [*model.named_parameters(), *model.named_buffers()] if t.is_meta]

    whole, _, _ = build_model_and_data(cfg, device="cpu")
    materialize_params(whole, cfg)
    prepare_params(whole, whole.cfg, tc)
    if derives_int8(whole.cfg):
        quantize_base_params(whole)
    shard_params(whole, mesh)
    want, want_train = _parts(whole)
    differ = sorted(n for n in want if n not in got or got[n].dtype != want[n].dtype
                    or not torch.equal(got[n], want[n]))
    return {"rank": dist.get_rank(), "all_meta": all_meta, "kept": kept, "still_meta": still_meta,
            "names": sorted(got), "want_names": sorted(want), "differ": differ,
            "trainable": got_train == want_train, "n": len(want),
            "int8": sorted(n for n, t in got.items() if t.dtype == torch.int8)}


def _worker(payload: str, out_dir: str) -> None:
    import torch.distributed as dist

    from test_torch_distributed import DIST_TIMEOUT

    from slam_llm_tpu_torch.pipeline.common import maybe_init_distributed

    torch.set_num_threads(1)
    assert maybe_init_distributed("cpu", timeout=DIST_TIMEOUT)
    for job in torch.load(payload, weights_only=False):
        result = _build_job(job)
        torch.save(result, Path(out_dir) / f"{job['name']}_rank{dist.get_rank()}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """One group of two ranks over the four cases."""
    sys.path.insert(0, str(HERE))
    from test_torch_distributed import _Group
    from test_torch_tensor_parallel import _run_cfg

    from slam_llm_tpu_torch.models.whisper import PRESETS
    from slam_llm_tpu_torch.pipeline import finetune
    from slam_llm_tpu_torch.tools.synth_checkpoint import write_whisper

    root = tmp_path_factory.mktemp("sharded_build")
    write_whisper(str(root / "whisper"), PRESETS["whisper-tiny-test"](), seed=5)
    int8 = {"model_config.encoder_path": str(root / "whisper"), "train_config.shard.ce_quant": "int8",
            "train_config.shard.base_quant_bwd": "int8_rot"}
    bf16 = {"train_config.shard.base_quant": "none", "train_config.shard.bwd_pretranspose": True}
    one = finetune.main(_run_cfg(root, **{"train_config.output_dir": str(root / "one"),
                                          "train_config.run_validation": False}), device="cpu")
    ckpt = {"ckpt_path": one["checkpoints"][-1]}
    cases = {"fsdp2_int8": (2, 1, int8), "tp2_int8": (1, 2, int8), "tp2_pretranspose": (1, 2, bf16),
             "fsdp2_ckpt": (2, 1, ckpt)}
    jobs = [{"name": name, "fsdp": fsdp, "tp": tp, "cfg": _run_cfg(root, **extra)}
            for name, (fsdp, tp, extra) in cases.items()]
    group = _Group(WORLD, jobs, root / "group", script=Path(__file__))
    group.wait()
    yield {name: [torch.load(root / "group" / f"{name}_rank{r}.pt", weights_only=False) for r in range(WORLD)]
           for name in cases}


@pytest.mark.parametrize("case", ["fsdp2_int8", "tp2_int8", "tp2_pretranspose", "fsdp2_ckpt"])
def test_sharded_build_equals_the_whole_build_bit_for_bit(built, case):
    for res in built[case]:
        assert res["all_meta"] and res["kept"] > 0  # on meta, the built non-zero values kept on the host
        assert res["still_meta"] == []
        assert res["names"] == res["want_names"] and res["trainable"]
        assert res["differ"] == [], res["differ"][:8]
        if case.endswith("int8"):
            assert any(n.endswith("kernel_qr") for n in res["int8"]) and "llm.head_q" in res["int8"]
        if case == "tp2_pretranspose":
            assert any(n.endswith("kernel_t") for n in res["names"])


if __name__ == "__main__":
    sys.path.insert(0, str(HERE))
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    _worker(sys.argv[1], sys.argv[2])
