"""Device prefetch: overlap host work and the host-to-device copy with the
step on the card (counterpart of `vjepa2_tpu/data/prefetch.py`).

The reference relies on pinned memory and ``non_blocking`` copies
(`app/vjepa/train.py:393-400`); JAX keeps a small queue of batches already
`device_put`. Here, on a CUDA device, each host tensor of a staged item is
copied into a pinned buffer and sent with a ``non_blocking`` copy on a side
stream; an event recorded after the copies travels with the item, the
consumer's stream waits on it before the item is yielded, and every yielded
tensor is `record_stream`-ed on the consumer's stream so that the caching
allocator does not hand its memory out while the step still reads it. On the
CPU the copy is a plain ``.to(device)``: the caller names the device.

A producer thread runs the transform (collate, casts, mask
sampling) and the copies run off the training thread, which mostly waits on
the card. Its exceptions re-raise in the consumer; items staged when the
consumer leaves are dropped and the thread is stopped.
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch


def _tree_map(fn, item):
    if isinstance(item, (list, tuple)):
        return type(item)(_tree_map(fn, x) for x in item)
    if isinstance(item, dict):
        return {k: _tree_map(fn, v) for k, v in item.items()}
    return fn(item)


def _leaves(item):
    if isinstance(item, (list, tuple)):
        for x in item:
            yield from _leaves(x)
    elif isinstance(item, dict):
        for x in item.values():
            yield from _leaves(x)
    else:
        yield item


class _Stager:
    """Applies the transform and moves the item's arrays to ``device``; on a
    CUDA device through pinned buffers on a side stream."""

    def __init__(self, transform, device):
        self.transform = transform
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None

    def __call__(self, item):
        if self.transform is not None:
            item = self.transform(item)

        def move(x):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x)
            if not isinstance(x, torch.Tensor):
                return x
            if not self.cuda:
                return x.to(self.device)
            if x.device.type == "cpu":
                x = x.pin_memory()
            return x.to(self.device, non_blocking=True)

        if not self.cuda:
            return _tree_map(move, item), None
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            item = _tree_map(move, item)
            event = torch.cuda.Event()
            event.record(self.stream)
        return item, event

    def release(self, staged):
        """The item, made safe to use on the consumer's current stream."""
        item, event = staged
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for x in _leaves(item):
                if isinstance(x, torch.Tensor) and x.device.type == "cuda":
                    x.record_stream(stream)
        return item


def device_prefetch(iterator: Iterable, size: int = 2, transform: Optional[Callable] = None,
                    device="cuda") -> Iterator:
    """Yield items with up to ``size`` already on ``device``.

    transform: host-side fn applied before the copy (collate, casts).
    device: where the arrays (numpy or torch, in nested lists, tuples and
        dicts) go; other leaves pass through.
    The staging runs on a producer thread, so host work overlaps the step
    even when the loader is in-process.
    """
    stager = _Stager(transform, device)

    q: _queue.Queue = _queue.Queue(maxsize=max(1, size))
    stop = threading.Event()
    sentinel = object()
    failure: list[BaseException] = []

    def _put(item) -> bool:
        # bounded-blocking put that aborts if the consumer went away
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except _queue.Full:
                continue
        return False

    def producer():
        try:
            for raw in iterator:
                if stop.is_set() or not _put(stager(raw)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            failure.append(e)
        finally:
            _put(sentinel)

    thread = threading.Thread(target=producer, daemon=True, name="device-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if failure:
                    raise failure[0]
                return
            yield stager.release(item)
    finally:
        stop.set()
        # drop what the producer staged (device memory) and let it see stop
        try:
            while True:
                q.get_nowait()
        except _queue.Empty:
            pass
        thread.join(timeout=10.0)

