"""Host-side data loading: length-grouped batching + threaded prefetch.

Counterpart of ``slam_llm_tpu/data/loader.py``: the same samplers, worker
pool and shared-memory transport, so both packages draw the same batches.

Replaces torch's DataLoader/Sampler stack. ``LengthBasedBatchSampler``
mirrors the reference's sampler semantics (reference data/sampler.py:11-40:
sort by length -> contiguous batches -> shuffle batch order) so batches are
length-homogeneous — which with bucketed collation (speech_dataset.py)
minimizes padding waste AND the number of distinct compiled shapes.

``PrefetchLoader`` overlaps host work (wav decode, mel, tokenize, collate)
with device steps via a worker pool + bounded queue, the host half of the
double-buffering the TPU needs to stay busy. Workers are threads by default
(zero-copy handoff; fine while numpy's FFT/matmul release the GIL) or
processes (``worker_type="process"``) for feeding rates where the
GIL-holding share of per-utterance work — wav decode, tokenization, python
collation — caps thread scaling; a v5e host must feed ~240 utt/s for its 4
chips (replaces the reference's torch DataLoader worker processes).

Process-pool transport (measured at the flagship 23.5 MB batch, bench.py):
the default result pickle costs the PARENT ~36 ms/batch (pipe read at
~0.5 GB/s + deserialize) — one parent core saturates near 660 utt/s at
B=24. ``worker_type="process"`` therefore hands arrays over via POSIX
shared memory: the worker writes the collated batch into a segment
(+~27 ms, on the scaling side of the boundary) and the parent attaches
(~0.01 ms) + copies out (~15 ms, GIL released) — ~2.4x more parent
headroom with ordinary owning arrays and no segment lifetime on consumers.
``worker_type="process_pickle"`` keeps the plain pickle transport.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

# process-worker state: installed once per worker via the pool initializer
# (fork start method: the dataset is inherited copy-on-write, the initargs
# pickle is paid once per worker, not per batch)
_WORKER_STATE: Optional[tuple] = None


def _process_worker_init(dataset, collator):
    global _WORKER_STATE
    _WORKER_STATE = (dataset, collator)


def _process_worker_collate(idxs):
    dataset, collator = _WORKER_STATE
    return collator([dataset[j] for j in idxs])


def _untrack_shm(name: str) -> None:
    """CPython <3.13 registers a segment with the per-process resource
    tracker on BOTH create and attach (bpo-39959); ownership here is explicit
    (worker creates, parent unlinks), so both sides unregister to avoid the
    tracker double-unlinking / warning on an already-removed name."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister("/" + name.lstrip("/"), "shared_memory")
    except Exception:
        pass


def _process_worker_collate_shm(idxs):
    """Collate, then hand the arrays to the parent through POSIX shared
    memory instead of the result pickle. Measured at the flagship batch
    shape (23.5 MB): the pickle path costs the PARENT ~36 ms/batch (pipe
    read + deserialize — a single parent core saturates near 660 utt/s at
    B=24), while attaching a shm segment costs ~0.01 ms — the parent-side
    ceiling disappears and the +~27 ms segment write stays on the workers,
    which scale with cores. Non-array fields (keys, targets) still ride the
    (small) result pickle."""
    from multiprocessing import shared_memory

    dataset, collator = _WORKER_STATE
    batch = collator([dataset[j] for j in idxs])
    arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    rest = {k: v for k, v in batch.items() if not isinstance(v, np.ndarray)}
    nbytes = sum(v.nbytes for v in arrays.values())
    if nbytes == 0:
        return None, {}, rest
    shm = shared_memory.SharedMemory(create=True, size=nbytes)
    meta, off = {}, 0
    try:
        for k, v in arrays.items():
            dst = np.ndarray(v.shape, v.dtype, buffer=shm.buf, offset=off)
            np.copyto(dst, v)
            meta[k] = (v.shape, v.dtype.str, off)
            off += v.nbytes
    finally:
        shm.close()  # parent re-attaches by name and owns the unlink
        _untrack_shm(shm.name)
    return shm.name, meta, rest


def _attach_shm_batch(name, meta, rest, copy: bool = True):
    """Parent side: attach the segment, copy the arrays out (one memcpy,
    ~15 ms at the flagship shape — still ~2.4x cheaper for the parent than
    the pickle path's pipe-read + deserialize, and it runs in the producer
    thread with the GIL released), then close + unlink. Copying keeps the
    yielded batch an ordinary owning ndarray dict: no lifetime contract on
    consumers, no /dev/shm leak windows. ``copy=False`` drops the data
    (teardown path for never-consumed futures)."""
    from multiprocessing import shared_memory

    if name is None:
        return dict(rest)
    shm = shared_memory.SharedMemory(name=name)
    try:
        batch = dict(rest)
        if copy:
            for k, (shape, dtype, off) in meta.items():
                view = np.ndarray(shape, np.dtype(dtype), buffer=shm.buf, offset=off)
                batch[k] = view.copy()
    finally:
        shm.close()
        try:
            shm.unlink()
        except FileNotFoundError:
            pass
        # no parent-side unregister: this Python registers only on CREATE
        # (the worker), and unlink() already unregisters locally if needed
    return batch


class LengthBasedBatchSampler:
    """Sort-by-length -> fixed-size batches -> shuffled batch order."""

    def __init__(
        self,
        lengths: Sequence[int],
        batch_size: int,
        drop_last: bool = True,
        shuffle: bool = True,
        seed: int = 0,
    ):
        self.lengths = list(lengths)
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[List[int]]:
        order = np.argsort(np.asarray(self.lengths), kind="stable")
        batches = [
            order[i : i + self.batch_size].tolist()
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches = batches[:-1]
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(batches)
        return iter(batches)

    def __len__(self) -> int:
        n = len(self.lengths) // self.batch_size
        if not self.drop_last and len(self.lengths) % self.batch_size:
            n += 1
        return n


class DistributedLengthBasedBatchSampler:
    """Rank-strided view over LengthBasedBatchSampler batches
    (reference data/sampler.py:42-57 islice semantics)."""

    def __init__(self, lengths, batch_size, num_replicas: int, rank: int,
                 ragged_tail: str = "drop", **kw):
        self.base = LengthBasedBatchSampler(lengths, batch_size, **kw)
        self.num_replicas = num_replicas
        self.rank = rank
        if ragged_tail not in ("drop", "wrap"):
            raise ValueError(f"ragged_tail={ragged_tail!r}: expected drop|wrap")
        self.ragged_tail = ragged_tail

    def set_epoch(self, epoch: int) -> None:
        self.base.set_epoch(epoch)

    def __iter__(self):
        # every rank MUST yield the same batch count: in SPMD an extra step
        # on one rank enters collectives alone and hangs the job (the
        # reference needs Join/monitored_barrier for this; we keep steps
        # equal by construction — SURVEY.md §5.3). "drop" discards the
        # ragged tail (training: the sample loss is negligible); "wrap"
        # re-decodes early batches so EVERY batch is covered (decode: a
        # dropped tail would silently score an incomplete test set;
        # duplicate keys collapse in the kaldi-style scoring dicts).
        n = len(self.base)
        if n == 0:
            return
        if self.ragged_tail == "drop":
            limit = n - n % self.num_replicas
            for i, batch in enumerate(self.base):
                if i >= limit:
                    break
                if i % self.num_replicas == self.rank:
                    yield batch
        else:
            batches = list(self.base)
            total = -(-n // self.num_replicas) * self.num_replicas
            for i in range(self.rank, total, self.num_replicas):
                yield batches[i % n]

    def __len__(self):
        n = len(self.base)
        if self.ragged_tail == "wrap":
            return -(-n // self.num_replicas) if n else 0
        return n // self.num_replicas


class PrefetchLoader:
    """Iterate collated batches with background workers.

    ``dataset`` must support ``__getitem__`` and provide ``collator``;
    ``sampler`` yields lists of indices. Batches are materialized by a thread
    pool and buffered in a bounded queue (depth ``prefetch``).
    """

    _END = object()

    def __init__(
        self,
        dataset,
        sampler,
        collator: Optional[Callable] = None,
        num_workers: int = 2,
        prefetch: int = 2,
        worker_type: str = "thread",  # "thread" | "process" | "process_pickle"
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.collator = collator or dataset.collator
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        if worker_type not in ("thread", "process", "process_pickle"):
            raise ValueError(
                f"worker_type must be thread|process|process_pickle, got {worker_type!r}"
            )
        # "process" hands batches over via POSIX shared memory (the parent
        # cost per batch drops from ~36 ms pickle+pipe to ~0.01 ms attach at
        # the flagship shape — see _process_worker_collate_shm);
        # "process_pickle" keeps the plain result-pickle transport
        self.worker_type = worker_type

    def _make_pool(self):
        if self.worker_type in ("process", "process_pickle"):
            import multiprocessing as mp

            return ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=mp.get_context("fork"),
                initializer=_process_worker_init,
                initargs=(self.dataset, self.collator),
            )
        return ThreadPoolExecutor(max_workers=self.num_workers)

    def _submit(self, pool, idxs):
        if self.worker_type == "process":
            return pool.submit(_process_worker_collate_shm, idxs)
        if self.worker_type == "process_pickle":
            return pool.submit(_process_worker_collate, idxs)
        return pool.submit(lambda ii: self.collator([self.dataset[j] for j in ii]), idxs)

    def __len__(self):
        return len(self.sampler)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put_best_effort(item):
            # never block forever on a full queue with a gone consumer
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def produce():
            pending = []
            try:
                with self._make_pool() as pool:
                    # pipeline: submit loads for upcoming batches, keep order
                    it = iter(self.sampler)
                    depth = max(self.prefetch + 1, self.num_workers)

                    def submit_next():
                        try:
                            idxs = next(it)
                        except StopIteration:
                            return False
                        pending.append(self._submit(pool, idxs))
                        return True

                    for _ in range(depth):
                        if not submit_next():
                            break
                    while pending:
                        if stop.is_set():
                            return
                        batch = pending.pop(0).result()
                        if self.worker_type == "process":
                            batch = _attach_shm_batch(*batch)
                        submit_next()
                        # bounded put that keeps watching stop: a consumer
                        # that abandons the iterator (e.g. next(iter(l)))
                        # would otherwise leave this thread blocked forever,
                        # leaking the pool + buffered batches per iterator
                        _put_best_effort(batch)
            except Exception as e:  # surface worker errors to the consumer
                _put_best_effort(e)
            finally:
                # segments created by workers for never-consumed futures
                # would outlive the run as /dev/shm files — collect + unlink
                if self.worker_type == "process":
                    for fut in pending:
                        try:
                            res = fut.result(timeout=30)
                        except Exception:
                            continue
                        _attach_shm_batch(*res, copy=False)
                _put_best_effort(self._END)

        t = threading.Thread(target=produce, daemon=True)
        t.start()

        try:
            while True:
                item = q.get()
                if item is self._END:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def build_dataloader(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    drop_last: bool = True,
    num_workers: int = 2,
    prefetch: int = 2,
    num_replicas: int = 1,
    rank: int = 0,
    seed: int = 0,
    ragged_tail: str = "drop",  # "wrap" for decode: cover every batch
    worker_type: str = "thread",
) -> PrefetchLoader:
    lengths = [dataset.sort_key(i) for i in range(len(dataset))]
    if num_replicas > 1:
        sampler = DistributedLengthBasedBatchSampler(
            lengths, batch_size, num_replicas, rank,
            ragged_tail=ragged_tail,
            drop_last=drop_last, shuffle=shuffle, seed=seed,
        )
    else:
        sampler = LengthBasedBatchSampler(
            lengths, batch_size, drop_last=drop_last, shuffle=shuffle, seed=seed
        )
    return PrefetchLoader(
        dataset, sampler, num_workers=num_workers, prefetch=prefetch,
        worker_type=worker_type,
    )
