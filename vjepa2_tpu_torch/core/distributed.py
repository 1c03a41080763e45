"""Several processes, one per GPU (counterpart of `vjepa2_tpu/core/distributed.py`;
reference `src/utils/distributed.py:init_distributed`).

The reference rendezvouses NCCL from environment variables and SLURM on a
fixed port; JAX calls `jax.distributed.initialize`. The port starts a
`torch.distributed` process group: NCCL where the ranks compute on CUDA
devices, gloo on the CPU, or the backend the caller names; it never swaps
either on its own. Each rank computes on ``cuda:LOCAL_RANK``. One process
with no cluster environment stays a process without a group, as in JAX.

`resolve_cluster` keeps JAX's priority: an explicit override first (here
torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK`` where JAX reads ``JAX_*``), then SLURM with one task per GPU,
then a Kubernetes JobSet.
"""

from __future__ import annotations

import os
import re
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the reference rendezvouses on a fixed port (`src/utils/distributed.py:17`)
DEFAULT_COORDINATOR_PORT = 37129

# gradient all-reduce buckets, DDP's default ``bucket_cap_mb``
BUCKET_BYTES = 25 * 2**20


def first_slurm_host(nodelist: str) -> str:
    """First hostname of a SLURM compressed nodelist ('node001',
    'node[001-004]', 'node[3,7-9]', 'a[1-2],b[5]')."""
    first = nodelist.split(",")[0]
    m = re.match(r"^([^\[]+)\[([0-9]+)", first)
    if m:
        return m.group(1) + m.group(2)
    return first.split("[")[0]


def _int(env: Mapping[str, str], key: str) -> Optional[int]:
    return int(env[key]) if env.get(key) else None


def resolve_cluster(env: Mapping[str, str]
                    ) -> tuple[Optional[str], Optional[int], Optional[int], Optional[int]]:
    """(coordinator "host:port", num_processes, process_id, local_rank) from a
    scheduler's environment, a pure function of ``env`` (JAX's order).

    * torchrun's ``WORLD_SIZE`` / ``RANK`` (with ``MASTER_ADDR``,
      ``MASTER_PORT``, ``LOCAL_RANK``): a partial set raises, as JAX's
      partial ``JAX_*`` override does;
    * SLURM, one task per GPU: ``SLURM_NTASKS``, ``SLURM_PROCID``,
      ``SLURM_LOCALID``, the coordinator ``MASTER_ADDR`` or the first host
      of the nodelist, on ``MASTER_PORT`` or 37129;
    * a JobSet pod: ``JOB_COMPLETION_INDEX``, ``NUM_PROCESSES``,
      ``COORDINATOR_ADDRESS`` (one process a pod, local rank 0);
    * none of them: (None, None, None, None).
    """
    num, pid = _int(env, "WORLD_SIZE"), _int(env, "RANK")
    if num is not None or pid is not None:
        coord = env.get("MASTER_ADDR")
        if num is not None and (coord is None or pid is None):
            raise ValueError(
                "Partial torchrun cluster override: set MASTER_ADDR, WORLD_SIZE and RANK "
                f"together (got addr={coord!r}, world={num!r}, rank={pid!r})")
        if num is None:
            raise ValueError("RANK set without WORLD_SIZE/MASTER_ADDR")
        if ":" not in coord:
            coord = f"{coord}:{env.get('MASTER_PORT', DEFAULT_COORDINATOR_PORT)}"
        return coord, num, pid, _int(env, "LOCAL_RANK") or 0

    if env.get("SLURM_PROCID") is not None and env.get("SLURM_NTASKS"):
        nodelist = env.get("SLURM_STEP_NODELIST") or env.get("SLURM_JOB_NODELIST", "")
        coord = env.get("MASTER_ADDR") or (first_slurm_host(nodelist) if nodelist else None)
        if coord and ":" not in coord:
            coord = f"{coord}:{env.get('MASTER_PORT', DEFAULT_COORDINATOR_PORT)}"
        return (coord, int(env["SLURM_NTASKS"]), int(env["SLURM_PROCID"]),
                _int(env, "SLURM_LOCALID") or 0)

    if env.get("JOB_COMPLETION_INDEX") is not None and env.get("NUM_PROCESSES"):
        coord = env.get("COORDINATOR_ADDRESS")
        if coord and ":" not in coord:
            coord = f"{coord}:{env.get('COORDINATOR_PORT', DEFAULT_COORDINATOR_PORT)}"
        return coord, int(env["NUM_PROCESSES"]), int(env["JOB_COMPLETION_INDEX"]), 0

    return None, None, None, None


def init_method(coordinator: str) -> str:
    """A process group's ``init_method``: "host:port" becomes a TCP store's
    URL; a URL (``tcp://``, ``file://``) passes as given."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     device="cuda", backend: Optional[str] = None,
                     local_rank: Optional[int] = None) -> tuple[int, int]:
    """Join the process group; returns (rank, world size).

    Arguments come from the command line or, all three None, from the
    scheduler (`resolve_cluster`). On a CUDA ``device`` the backend is NCCL
    and this rank computes on ``cuda:local_rank`` (the scheduler's local
    rank, else ``process_id`` modulo the visible cards); a rank without a
    card raises, as `core.device.entry_device` does. On the CPU it is gloo.
    ``backend`` names another (gloo for CUDA tensors of several ranks on one
    card, which NCCL refuses). With no argument and no cluster environment
    nothing starts: one process, (0, 1). On the card the rank's current
    device is set, so the entry points' ``"cuda"`` is ``cuda:local_rank``.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    url = None
    if coordinator_address is None and num_processes is None and process_id is None:
        coordinator_address, num_processes, process_id, env_local = resolve_cluster(os.environ)
        local_rank = env_local if local_rank is None else local_rank
        if os.environ.get("TORCHELASTIC_RUN_ID"):
            url = "env://"  # torchrun's agent already serves the store on MASTER_PORT
    given = (coordinator_address, num_processes, process_id)
    if all(x is None for x in given):
        return 0, 1
    if any(x is None for x in given):
        raise ValueError("several processes need a coordinator, a process count and this "
                         f"process's id (got {coordinator_address!r}, {num_processes!r}, "
                         f"{process_id!r})")
    device = torch.device(device)
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device visible: this rank computes on the card; pass "
                               "device='cpu' for CPU ranks")
        local_rank %= torch.cuda.device_count()
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                            init_method=url or init_method(coordinator_address),
                            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def world() -> tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    if initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def world_group():
    """The group of every process, None in one process."""
    return dist.group.WORLD if world()[1] > 1 else None


def is_main_process() -> bool:
    return world()[0] == 0


def barrier() -> None:
    """Every rank waits for the others; a no-op in one process."""
    if world()[1] > 1:
        dist.barrier()


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def destroy(meet: bool = True) -> None:
    """Leave the process group, if there is one. With ``meet`` every rank
    first meets the others at a barrier: a rank that left at once could
    close its connections while a peer still reads from them, and a gloo
    peer that loses a connection mid-transfer aborts its process. A rank
    that leaves on an error does not wait (its peers fail on the closed
    connections instead of waiting for it)."""
    if initialized():
        if meet and dist.get_world_size() > 1:
            dist.barrier()
        _CONTROL.clear()
        dist.destroy_process_group()


_CONTROL = {}  # the gloo group host flags are agreed over, made at first use


def any_process(flag: bool) -> bool:
    """Whether ``flag`` holds on any process (a SIGTERM that reached some
    ranks stops them all at the same step): a max-reduce over a gloo group
    of host tensors, which waits for no card."""
    if world()[1] == 1:
        return flag
    if "group" not in _CONTROL:
        _CONTROL["group"] = (dist.group.WORLD if dist.get_backend() == "gloo"
                             else dist.new_group(backend="gloo"))
    t = torch.tensor([int(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_CONTROL["group"])
    return bool(t.item())


def _reduce_device() -> torch.device:
    """Where a host value is reduced: the card under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_sum(x):
    """Sum a host value (numpy array or scalar) over every process: the
    reference all-reduces its eval statistics each epoch
    (`evals/video_classification_frozen/eval.py:329`). Identity in one
    process; else a numpy array of ``x``'s shape."""
    if world()[1] == 1:
        return x
    a = np.asarray(x)
    t = torch.as_tensor(a, device=_reduce_device()).clone()
    dist.all_reduce(t)
    return t.cpu().numpy()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def mean_(tensors: Sequence[torch.Tensor], group, bucket_bytes: int = BUCKET_BYTES) -> None:
    """Replace each tensor by its mean over ``group``, in place: the tensors
    of one dtype are flattened into buckets of at most ``bucket_bytes``
    (DDP's default), each summed by one all-reduce and scaled by 1/size.
    Every rank ends with the same bits. A no-op for a group of one."""
    size = group_size(group)
    if size == 1 or not tensors:
        return
    inv = 1.0 / size
    buckets: list[list[torch.Tensor]] = []
    open_: dict = {}  # (dtype, device) -> (bucket, its bytes)
    for t in tensors:
        key = (t.dtype, t.device)
        b, nbytes = open_.get(key, (None, 0))
        if b is None or nbytes + t.nbytes > bucket_bytes:
            b, nbytes = [], 0
            buckets.append(b)
        b.append(t)
        open_[key] = (b, nbytes + t.nbytes)
    for b in buckets:
        flat = torch.cat([t.reshape(-1) for t in b])
        dist.all_reduce(flat, group=group)
        flat.mul_(inv)
        offset = 0
        for t in b:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def mean_gradients(params: Sequence[torch.Tensor], group) -> None:
    """The data-parallel step's gradient mean: every ``.grad`` of
    ``params`` averaged over ``group`` (`mean_`), so that AdamW makes the
    same update on every rank."""
    mean_([p.grad for p in params if p.grad is not None], group)


def mean_metric(x: torch.Tensor, group) -> torch.Tensor:
    """A metric's mean over ``group`` (the global batch's loss), as a new
    tensor; ``x`` itself in a group of one."""
    if group_size(group) == 1:
        return x
    y = x.detach().clone()
    mean_([y], group)
    return y
