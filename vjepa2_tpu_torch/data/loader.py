"""Multiprocess prefetching data loader on the host (counterpart of
`vjepa2_tpu/data/loader.py`; replaces torch's DataLoader and the reference's
`NondeterministicDataLoader`, `src/datasets/utils/dataloader.py:144-223`).

Worker processes decode, transform and collate a batch's samples, and hand
the batch's large arrays over in shared memory (`multiprocessing.
shared_memory`): through the queue's pipe, as JAX hands over its samples (and
collates them in the main process), the H100 host's loader delivered 6.3
clips/s of float32 16f@256 clips from 8 workers, and through shared memory
69.7 (`chip_smoke.py` train_disk, `PERF.md` §6 PR 20).
``ordered=False`` yields batches as workers finish them (the
reference's out-of-order iterator, no head-of-line blocking);
``ordered=True`` yields them in the sampler's order. The workers are
spawned, never forked: the trainer holds a live CUDA context (JAX spawns for
its runtime's threads, `loader.py:155-158`), and no more of them than the
epoch has batches (each costs seconds to start). The mask collator runs in
the trainer, not in the workers.

Two departures from JAX, each pinned by a test named after it (ROADMAP
queue C):

- Batch ``b`` goes to worker ``b % num_workers`` through that worker's own
  queue, where JAX's workers take batches from one shared queue. A batch's
  random draws then do not depend on which worker won the race for it, so a
  run and its resume see the same clips.
- Each worker draws the dataset's windows and crops from a stream of its own,
  ``SeedSequence([seed, rank, worker, epoch])``. JAX seeds only numpy's
  global generator in a worker, and every spawned worker unpickles the same
  ``dataset.rng``: siblings drew the same windows and crops for different
  samples.
"""

from __future__ import annotations

import itertools
import multiprocessing as mp
import queue
import time
from multiprocessing import shared_memory
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

# arrays from this size on go through shared memory, smaller ones through the pipe
SHARED_MIN_BYTES = 1 << 20


def default_collate(samples):
    """[(clips_list, label, clip_indices), ...] -> (clips [num_clips][B, T, H,
    W, C], labels [B], clip_indices [num_clips][B, T]), numpy."""
    num_clips = len(samples[0][0])
    clips = [np.stack([s[0][c] for s in samples]) for c in range(num_clips)]
    labels = np.asarray([s[1] for s in samples])
    clip_indices = [np.stack([np.asarray(s[2][c]) for s in samples])
                    for c in range(len(samples[0][2]))]
    return clips, labels, clip_indices


class FpcBucketSampler:
    """Wraps an index sampler so that every batch has ONE frames-per-clip:
    indices gather in a bucket a fpc, and a full bucket is a batch (the
    reference splits a mixed batch into per-fpc sub-batches inside the step,
    `src/masks/multiseq_multiblock3d.py:57-74`; a bucket a step keeps one
    shape a step function)."""

    def __init__(self, sampler, fpc_of_index, batch_size: int):
        self.sampler = sampler
        self.fpc_of_index = fpc_of_index
        self.batch_size = batch_size

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __iter__(self):
        buckets: dict[int, list[int]] = {}
        for idx in self.sampler:
            b = buckets.setdefault(self.fpc_of_index(idx), [])
            b.append(idx)
            if len(b) == self.batch_size:
                yield list(b)
                b.clear()


def seed_worker(dataset, seed: int, rank: int, worker_id: int, epoch: int) -> None:
    """Seed a worker: numpy's global generator from ``SeedSequence([seed,
    rank, worker])`` (JAX's), and the dataset's generator, where it has one,
    from a stream of the worker's own for this epoch."""
    ss = np.random.SeedSequence([seed, rank, worker_id])
    np.random.seed(ss.generate_state(4))
    if isinstance(getattr(dataset, "rng", None), np.random.Generator):
        dataset.rng = np.random.default_rng([seed, rank, worker_id, epoch])


class _Shared:
    """An array left in a shared-memory segment by a worker."""

    def __init__(self, name: str, shape: tuple, dtype: str):
        self.name, self.shape, self.dtype = name, shape, dtype


def _share(tree):
    """``tree`` (lists, tuples and dicts of arrays) with each array of
    `SHARED_MIN_BYTES` or more copied into a new shared-memory segment and
    replaced by its `_Shared` record."""
    if isinstance(tree, np.ndarray) and tree.nbytes >= SHARED_MIN_BYTES:
        shm = shared_memory.SharedMemory(create=True, size=tree.nbytes)
        np.ndarray(tree.shape, tree.dtype, buffer=shm.buf)[...] = tree
        shm.close()
        return _Shared(shm.name, tree.shape, tree.dtype.str)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_share(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _share(v) for k, v in tree.items()}
    return tree


def _unshare(tree, keep: bool = True):
    """`_share`'s inverse: each segment copied out (with ``keep``) and
    unlinked."""
    if isinstance(tree, _Shared):
        shm = shared_memory.SharedMemory(name=tree.name)
        try:
            return (np.ndarray(tree.shape, np.dtype(tree.dtype), buffer=shm.buf).copy()
                    if keep else None)
        finally:
            shm.close()
            shm.unlink()
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unshare(t, keep) for t in tree)
    if isinstance(tree, dict):
        return {k: _unshare(v, keep) for k, v in tree.items()}
    return tree


def _worker_loop(dataset, index_queue, result_queue, seed, monitor_dir=None, worker_id=0,
                 rank=0, epoch=0, collate_fn=default_collate):
    seed_worker(dataset, seed, rank, worker_id, epoch)
    if monitor_dir is not None:
        # per-worker resource rows (reference `MonitoredDataset`,
        # `src/datasets/utils/dataloader.py:68-141`)
        from vjepa2_tpu_torch.core.monitoring import ResourceMonitoringThread

        ResourceMonitoringThread(f"{monitor_dir}/worker_{worker_id}.csv", interval=5.0).start()
    while True:
        item = index_queue.get()
        if item is None:
            return
        batch_id, indices = item
        try:
            batch = _share(collate_fn([dataset[i] for i in indices]))
        except Exception as e:
            result_queue.put((batch_id, None, e))
        else:
            result_queue.put((batch_id, batch, None))


class DataLoader:
    def __init__(
        self,
        dataset,
        sampler: Iterable[int],
        batch_size: int,
        num_workers: int = 0,
        collate_fn: Callable = default_collate,
        drop_last: bool = True,
        ordered: bool = False,
        prefetch_factor: int = 2,
        seed: int = 0,
        epoch_len: Optional[int] = None,
        batch_sampler: Optional[Iterable[list[int]]] = None,
        monitor_dir: Optional[str] = None,
        rank: int = 0,
        mp_context: str = "spawn",
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.collate_fn = collate_fn
        self.drop_last = drop_last
        self.ordered = ordered
        self.prefetch_factor = prefetch_factor
        self.seed = seed
        self.epoch_len = epoch_len
        self.batch_sampler = batch_sampler
        self.monitor_dir = monitor_dir
        self.rank = rank
        self.mp_context = mp_context
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """The sampler's order, the dataset's draws and the workers' streams
        of epoch ``epoch`` (JAX's loop never sets one: every epoch replays
        epoch 0, ROADMAP queue C)."""
        self.epoch = epoch
        for obj in (self.batch_sampler, self.sampler, self.dataset):
            if obj is not None and hasattr(obj, "set_epoch"):
                obj.set_epoch(epoch)

    def batched_indices(self) -> Iterator[list[int]]:
        """The sample indices of each batch, in order."""
        if self.batch_sampler is not None:
            for n, batch in enumerate(self.batch_sampler):
                if self.epoch_len is not None and n >= self.epoch_len:
                    return
                yield batch
            return
        it = iter(self.sampler)
        n = 0
        while self.epoch_len is None or n < self.epoch_len:
            batch = list(itertools.islice(it, self.batch_size))
            if len(batch) < self.batch_size:
                if batch and not self.drop_last:
                    yield batch
                return
            n += 1
            yield batch

    def __iter__(self):
        if self.num_workers == 0:
            for batch in self.batched_indices():
                yield self.collate_fn([self.dataset[i] for i in batch])
            return
        yield from self._iter_workers()

    def _iter_workers(self):
        # no more workers than batches: worker w would take batch w first,
        # so a short epoch's batches are the same with the idle ones left out
        batches = self.batched_indices()
        head = list(itertools.islice(batches, self.num_workers))
        if not head:
            return
        num_workers = len(head)
        ctx = mp.get_context(self.mp_context)
        index_queues = [ctx.Queue() for _ in range(num_workers)]
        result_queue = ctx.Queue()
        workers = [
            ctx.Process(target=_worker_loop,
                        args=(self.dataset, index_queues[w], result_queue, self.seed,
                              self.monitor_dir, w, self.rank, self.epoch, self.collate_fn),
                        daemon=True)
            for w in range(num_workers)]
        for w in workers:
            w.start()
        try:
            batch_iter = enumerate(itertools.chain(head, batches))
            in_flight, next_emit, exhausted = 0, 0, False
            max_in_flight = num_workers * self.prefetch_factor
            held: dict[int, object] = {}

            def submit():
                nonlocal in_flight, exhausted
                while not exhausted and in_flight < max_in_flight:
                    try:
                        bid, idxs = next(batch_iter)
                    except StopIteration:
                        exhausted = True
                        return
                    index_queues[bid % num_workers].put((bid, idxs))
                    in_flight += 1

            submit()
            while in_flight > 0:
                bid, shared, err = self._next_result(result_queue, workers)
                in_flight -= 1
                submit()
                if err is not None:
                    raise err
                batch = _unshare(shared)
                if not self.ordered:
                    yield batch
                    continue
                held[bid] = batch
                while next_emit in held:
                    yield held.pop(next_emit)
                    next_emit += 1
            for b in sorted(held):
                yield held[b]
        finally:
            for q in index_queues:
                q.put(None)
            # drain the results left (a closed or failed iteration) while the
            # workers exit: a worker cannot exit before its pipe is read
            deadline = time.monotonic() + 5.0
            while any(w.is_alive() for w in workers) and time.monotonic() < deadline:
                try:
                    _unshare(result_queue.get(timeout=0.05)[1], keep=False)
                except queue.Empty:
                    pass
            for w in workers:
                if w.is_alive():
                    w.terminate()
                w.join()

    @staticmethod
    def _next_result(result_queue, workers):
        """The next worker result; raises if a worker died meanwhile."""
        while True:
            try:
                return result_queue.get(timeout=5.0)
            except queue.Empty:
                dead = [(i, w.exitcode) for i, w in enumerate(workers) if not w.is_alive()]
                if dead:
                    raise RuntimeError(f"loader workers exited: {dead} (worker, exit code)")
