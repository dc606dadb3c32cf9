"""The port's training loop against the reference's: the batch order of each
epoch, the profiler window, and the builders' default device (CPU, tiny)."""

import inspect
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from slam_llm_tpu.data.loader import LengthBasedBatchSampler as JLengthBasedBatchSampler
from slam_llm_tpu_torch.data.loader import build_dataloader
from slam_llm_tpu_torch.train.loop import train


class _Items:
    """A dataset of ``n`` items whose collated batch is the item indices."""

    def __init__(self, lengths):
        self.lengths = lengths

    def __len__(self):
        return len(self.lengths)

    def __getitem__(self, i):
        return i

    def sort_key(self, i):
        return self.lengths[i]

    @staticmethod
    def collator(items):
        return {"idx": np.asarray(items)}


class _RecordingTrainer:
    """Takes the loop's steps on the CPU, recording each batch's indices and
    running a little torch work for the profiler to see."""

    def __init__(self):
        self.step, self.device, self.seen = 0, torch.device("cpu"), []

    def put_batch(self, batch):
        return batch

    def train_step(self, batch):
        self.seen.append(batch["idx"].tolist())
        x = torch.ones(16, 16)
        return {"loss": (x @ x).sum()}


def _tc(epochs):
    return SimpleNamespace(num_epochs=epochs, max_steps_per_epoch=0, log_interval=10**6, run_validation=False,
                           save_model=False, validation_interval=10**6)


def test_each_epoch_draws_the_reference_batch_order():
    """Two epochs through ``train``: epoch e's batches are the reference
    sampler's after ``set_epoch(e)`` (same lengths, batch size and seed),
    and the two epochs differ."""
    rng = np.random.default_rng(0)
    lengths = rng.integers(10, 500, size=40).tolist()
    loader = build_dataloader(_Items(lengths), batch_size=4, seed=7, num_workers=1)
    trainer = _RecordingTrainer()
    train(trainer, loader, train_config=_tc(2))
    per_epoch = len(lengths) // 4
    epochs = [trainer.seen[:per_epoch], trainer.seen[per_epoch:]]
    assert len(trainer.seen) == 2 * per_epoch
    for e, got in enumerate(epochs):
        ref = JLengthBasedBatchSampler(lengths, 4, seed=7)
        ref.set_epoch(e)
        assert got == [list(b) for b in ref], e
    assert epochs[0] != epochs[1]


@pytest.mark.parametrize("start,steps,n_epochs,want", [(1, 1, 1, [(1, 2)]), (3, 10, 2, [(3, 6)])])
def test_profile_window_writes_one_trace(tmp_path, start, steps, n_epochs, want):
    """``log_config.profile_dir`` traces steps [start, start + steps) of the
    run, counted across epochs, into one Chrome trace; a window still open
    when training ends is closed and written."""
    loader = build_dataloader(_Items(list(range(12))), batch_size=4, seed=0, num_workers=1)
    log = SimpleNamespace(use_wandb=False, log_file=None, log_interval=10**6, profile_dir=str(tmp_path / "prof"),
                          profile_start=start, profile_steps=steps)
    res = train(_RecordingTrainer(), loader, train_config=_tc(n_epochs), log_config=log)
    files = sorted((tmp_path / "prof").iterdir())
    assert [f.name for f in files] == [f"trace_steps_{a}-{b}.json" for a, b in want]
    assert res["traces"] == [str(f) for f in files]
    assert '"traceEvents"' in files[0].read_text()


def test_no_profile_dir_writes_nothing(tmp_path):
    loader = build_dataloader(_Items(list(range(8))), batch_size=4, seed=0, num_workers=1)
    res = train(_RecordingTrainer(), loader, train_config=_tc(1))
    assert res["traces"] == []


def test_builders_default_to_the_card():
    """Every public builder of the port runs on the card unless asked for
    the CPU; without a GPU, the default raises instead of falling back."""
    from slam_llm_tpu_torch.pipeline import common

    assert inspect.signature(common.build_model_and_data).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            common.build_model_and_data(common.RunConfig())
