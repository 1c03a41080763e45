"""`vjepa2_tpu_torch/data/prefetch.py`: the batches come in order, a
producer's exception re-raises in the consumer, and a consumer that leaves
early leaves no thread running. The ``cuda`` case holds the side-stream copy against the host
batch on the card, read by a kernel on the consumer's stream right after the
yield; it skips without a card (``--noconftest`` runs it where jax is
absent).
"""

import threading
import time

import numpy as np
import pytest
import torch

from vjepa2_tpu_torch.data.prefetch import device_prefetch


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "device-prefetch"]


def _batches(n, shape=(4, 8)):
    for i in range(n):
        yield {"x": np.full(shape, i, np.float32), "ids": [torch.arange(3) + i]}, i


def test_order_and_transform():
    seen = list(device_prefetch(_batches(7), size=2, device="cpu",
                                transform=lambda b: (b[0]["x"] * 2, b[0]["ids"], b[1])))
    assert [i for _, _, i in seen] == list(range(7))
    for x, ids, i in seen:
        assert isinstance(x, torch.Tensor) and torch.equal(x, torch.full((4, 8), 2.0 * i))
        assert torch.equal(ids[0], torch.arange(3) + i)


def test_producer_exception_reraises():
    def broken():
        for i in range(3):
            yield np.zeros(2), i
        raise KeyError("decode failed")

    got = []
    with pytest.raises(KeyError, match="decode failed"):
        for _, i in device_prefetch(broken(), size=2, device="cpu"):
            got.append(i)
    # the items before the failure, in order (the look-ahead may hold some back)
    assert got == list(range(len(got))) and len(got) >= 3 - 2
    assert not _prefetch_threads()


def test_transform_runs_off_the_consumer_thread():
    consumer = threading.get_ident()
    threads = []

    def transform(item):
        threads.append(threading.get_ident())
        return item

    assert len(list(device_prefetch(_batches(4), size=2, device="cpu",
                                    transform=transform))) == 4
    assert len(threads) == 4 and consumer not in threads


def test_transform_exception_reraises():
    def transform(item):
        if item[1] == 2:
            raise ValueError("bad clip")
        return item

    got = []
    with pytest.raises(ValueError, match="bad clip"):
        for _, i in device_prefetch(_batches(5), size=2, device="cpu", transform=transform):
            got.append(i)
    assert got == [0, 1]
    assert not _prefetch_threads()


def test_early_exit_stops_the_producer():
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield np.full(3, i)
            i += 1

    it = device_prefetch(endless(), size=2, device="cpu")
    first = [next(it) for _ in range(3)]
    assert [int(x[0]) for x in first] == [0, 1, 2]
    it.close()
    assert not _prefetch_threads()
    n = len(produced)
    time.sleep(0.2)
    assert len(produced) == n  # nothing is staged after the consumer left


def test_early_exit_in_a_for_loop():
    for i, _ in enumerate(device_prefetch(_batches(100), size=3, device="cpu")):
        if i == 4:
            break
    deadline = time.time() + 10
    while _prefetch_threads() and time.time() < deadline:
        time.sleep(0.01)
    assert not _prefetch_threads()


@pytest.mark.cuda
def test_side_stream_copy_matches_the_host_batch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the copy runs on a side stream of the card)")
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    host = [rng.rand(16, 3, 256, 256).astype(np.float32) for _ in range(6)]
    # a busy consumer stream: a copy that the stream never waited for would
    # be read before it lands
    busy = torch.randn(4096, 4096, device=dev)
    for i, (x,) in enumerate(device_prefetch(((h,) for h in host), size=2, device=dev,
                                             transform=lambda b: (torch.from_numpy(b[0]),))):
        for _ in range(4):
            busy = busy @ busy / 64.0
        assert x.device == dev and x.is_contiguous()
        got = (x * 1.0).sum(dtype=torch.float64).item()
        assert got == pytest.approx(float(host[i].sum(dtype=np.float64)), rel=1e-9)
        assert torch.equal(x.cpu(), torch.from_numpy(host[i]))
