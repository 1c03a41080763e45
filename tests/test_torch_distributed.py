"""The port's process group and mesh (`core/distributed.py`, `core/mesh.py`)
against the JAX package's (`vjepa2_tpu/core/distributed.py`,
`vjepa2_tpu/core/mesh.py`).

* `first_slurm_host` and `resolve_cluster` on the env dicts of JAX's
  `tests/core/test_cluster_resolve.py`; in the override cases the port reads
  torchrun's names (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``, ``LOCAL_RANK``) where JAX reads ``JAX_*``, and both refuse a
  partial override.
* `MeshConfig.resolve` against JAX's on the cases of JAX's
  `tests/core/test_mesh.py:63` and a few more, `arrange_hybrid` with JAX's
  injected ``slice_of``, and the mesh layout's DCN check.
* `init_distributed`, `global_sum`, the bucketed gradient mean, `any_process`
  and the mesh's groups in 2 spawned gloo processes.
* The refusals: a partial set of process-group arguments, a CUDA rank
  without a card.

The spawned ranks run gloo over a FileStore in ``tmp_path`` with one thread
each; the functions they run import no JAX (JAX is imported inside the test
functions only).
"""

import re

import numpy as np
import pytest
import torch

from vjepa2_tpu_torch.core import distributed
from vjepa2_tpu_torch.core.mesh import (MeshConfig, arrange_hybrid, data_group, make_mesh,
                                        mesh_layout, model_group)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rank_main(rank, fn, world, store, out_dir, args):
    torch.set_num_threads(1)
    distributed.init_distributed("file://" + store, world, rank, device="cpu")
    try:
        out = fn(rank, world, *args)
    except BaseException:
        distributed.destroy(meet=False)
        raise
    distributed.destroy()
    torch.save(out, f"{out_dir}/out{rank}.pt")


def spawn(fn, world, tmp_path, *args):
    """``fn(rank, world, *args)`` in ``world`` spawned gloo ranks; their
    results, by rank."""
    store = tmp_path / f"store-{fn.__name__}-{world}"
    torch.multiprocessing.start_processes(
        _rank_main, (fn, world, str(store), str(tmp_path), args), nprocs=world, join=True,
        start_method="spawn")
    return [torch.load(tmp_path / f"out{r}.pt", weights_only=False) for r in range(world)]


NODELISTS = ["node001", "node[001-004]", "node[3,7-9]", "a[1-2],b[5]",
             "tpu-host-7,tpu-host-9"]


@pytest.mark.parametrize("nodelist", NODELISTS)
def test_first_slurm_host_matches_jax(nodelist):
    from vjepa2_tpu.core.distributed import first_slurm_host as jax_first

    assert distributed.first_slurm_host(nodelist) == jax_first(nodelist)


def _torchrun_names(env):
    """JAX's override names -> torchrun's."""
    out = {k: v for k, v in env.items() if not k.startswith("JAX_")}
    if "JAX_COORDINATOR_ADDRESS" in env:
        host, port = env["JAX_COORDINATOR_ADDRESS"].split(":")
        out.update(MASTER_ADDR=host, MASTER_PORT=port)
    if "JAX_NUM_PROCESSES" in env:
        out["WORLD_SIZE"] = env["JAX_NUM_PROCESSES"]
    if "JAX_PROCESS_ID" in env:
        out["RANK"] = env["JAX_PROCESS_ID"]
    return out


ENVS = {
    "override": {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234", "JAX_NUM_PROCESSES": "4",
                 "JAX_PROCESS_ID": "2", "SLURM_PROCID": "9", "SLURM_NTASKS": "99"},
    "slurm": {"SLURM_PROCID": "3", "SLURM_NTASKS": "8", "SLURM_JOB_NODELIST": "gpu[017-024]"},
    "slurm_master": {"SLURM_PROCID": "0", "SLURM_NTASKS": "2", "SLURM_JOB_NODELIST": "n[1-2]",
                     "MASTER_ADDR": "head.cluster", "MASTER_PORT": "4444"},
    "jobset": {"JOB_COMPLETION_INDEX": "5", "NUM_PROCESSES": "16",
               "COORDINATOR_ADDRESS": "job-0.headless.svc"},
    "none": {},
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_resolve_cluster_matches_jax(name):
    from vjepa2_tpu.core.distributed import resolve_cluster as jax_resolve

    env = ENVS[name]
    got = distributed.resolve_cluster(_torchrun_names(env) if name == "override" else env)
    assert got[:3] == jax_resolve(env)
    assert got[3] == (None if name == "none" else 0)


def test_resolve_cluster_local_ranks():
    env = {"MASTER_ADDR": "h", "WORLD_SIZE": "16", "RANK": "9", "LOCAL_RANK": "1"}
    assert distributed.resolve_cluster(env) == ("h:37129", 16, 9, 1)
    env = dict(ENVS["slurm"], SLURM_LOCALID="3")
    assert distributed.resolve_cluster(env) == ("gpu017:37129", 8, 3, 3)


@pytest.mark.parametrize("partial", [{"JAX_NUM_PROCESSES": "4"}, {"JAX_PROCESS_ID": "1"},
                                     {"JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "1"}])
def test_partial_override_is_refused_as_in_jax(partial):
    from vjepa2_tpu.core.distributed import resolve_cluster as jax_resolve

    with pytest.raises(ValueError):
        jax_resolve(partial)
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        distributed.resolve_cluster(_torchrun_names(partial))


MESHES = [((-1, 2, 2, 1), 8), ((3, 2, 2, 1), 8), ((-1, 1, 4, 1), 8), ((1, 1, 1, 1), 8),
          ((-1, 1, 1, 1), 1), ((2, 1, 1, 1), 1), ((-1, 1, 3, 1), 8), ((-1, 2, 1, 2), 8)]


@pytest.mark.parametrize("axes, n", MESHES)
def test_mesh_resolve_matches_jax(axes, n):
    from vjepa2_tpu.core.mesh import MeshConfig as JaxMeshConfig

    try:
        want = JaxMeshConfig(*axes).resolve(n)
    except AssertionError as e:
        with pytest.raises(AssertionError, match=re.escape(str(e))):
            MeshConfig(*axes).resolve(n)
    else:
        assert MeshConfig(*axes).resolve(n) == want


class FakeDev:
    def __init__(self, id, slice_index=None):
        self.id = id
        if slice_index is not None:
            self.slice_index = slice_index


def test_arrange_hybrid_matches_jax():
    from vjepa2_tpu.core.mesh import arrange_hybrid as jax_arrange
    from vjepa2_tpu.core.mesh import make_mesh as jax_make_mesh
    from vjepa2_tpu.core.mesh import MeshConfig as JaxMeshConfig

    devs = [FakeDev(i, i % 2) for i in range(8)]
    assert [d.id for d in arrange_hybrid(devs)] == [d.id for d in jax_arrange(devs)]
    plain = [FakeDev(i) for i in (2, 3, 0, 1)]
    assert [d.id for d in arrange_hybrid(plain)] == [2, 3, 0, 1]  # ranks keep their order
    node = lambda d: d.id % 2  # noqa: E731
    assert ([d.id for d in arrange_hybrid(plain, slice_of=node)]
            == [d.id for d in jax_arrange(plain, slice_of=node)] == [0, 2, 1, 3])
    assert list(arrange_hybrid(range(8))) == list(range(8))
    # fsdp*model must divide each node's ranks, as JAX's make_mesh requires
    for make in (lambda: mesh_layout(MeshConfig(-1, 8, 1), [FakeDev(i) for i in range(8)],
                                     slice_of=node),
                 lambda: jax_make_mesh(JaxMeshConfig(data=-1, fsdp=8, model=1),
                                       devices=[FakeDev(i) for i in range(8)], slice_of=node)):
        with pytest.raises(AssertionError, match="cross DCN"):
            make()
    # model varies fastest, pipe slowest (JAX `mesh.py:103`)
    layout = mesh_layout(MeshConfig(2, 1, 2, 2), range(8))
    assert layout.shape == (2, 2, 1, 2)
    assert layout[1, 0, 0].tolist() == [4, 5] and layout[0, 1, 0].tolist() == [2, 3]


def _groups(rank, world):
    out = {"init": distributed.world(), "sum": distributed.global_sum(np.array([rank + 1, 10])),
           "scalar": distributed.global_sum(np.int64(rank))}
    # the bucketed mean: three tensors in two dtypes, a 1-element bucket cap
    ts = [torch.full((3,), float(rank)), torch.arange(4.0) * (rank + 1),
          torch.full((2,), rank, dtype=torch.float64)]
    distributed.mean_(ts, distributed.world_group(), bucket_bytes=4)
    out["mean"] = ts
    out["any"] = (distributed.any_process(rank == 1), distributed.any_process(False))
    mesh = make_mesh(MeshConfig(data=-1, model=1), device_type="cpu")
    out["mesh"] = (mesh.get_local_rank("data"), mesh.shape[1], mesh.shape[3],
                   torch.distributed.get_world_size(data_group(mesh)),
                   torch.distributed.get_world_size(model_group(mesh)))
    distributed.barrier()
    return out


def test_two_processes(tmp_path):
    """Two gloo ranks: the group's (rank, world), sums of host values over the
    ranks, the gradient mean (bit-equal on both: 1/2 of the sums), a flag
    any rank raises reaching every rank, and the data-parallel mesh."""
    outs = spawn(_groups, 2, tmp_path)
    for rank, out in enumerate(outs):
        assert out["init"] == (rank, 2)
        np.testing.assert_array_equal(out["sum"], [3, 20])
        assert int(out["scalar"]) == 1
        assert torch.equal(out["mean"][0], torch.full((3,), 0.5))
        assert torch.equal(out["mean"][1], torch.arange(4.0) * 1.5)
        assert torch.equal(out["mean"][2], torch.full((2,), 0.5, dtype=torch.float64))
        assert out["any"] == (True, False)
        assert out["mesh"] == (rank, 2, 1, 2, 1)


def test_one_process_is_no_group():
    """No argument and no cluster environment: nothing starts, as in JAX."""
    assert distributed.init_distributed(device="cpu") == (0, 1)
    assert not distributed.initialized()
    assert distributed.global_sum(np.array([2, 3])).tolist() == [2, 3]
    x = torch.ones(2)
    distributed.mean_([x], distributed.world_group())
    assert distributed.mean_metric(x, None) is x and distributed.any_process(True)


@pytest.mark.parametrize("args", [(None, 2, None), (None, None, 1), ("h:1", None, None),
                                  ("h:1", 2, None)])
def test_partial_arguments_are_refused(args):
    with pytest.raises(ValueError, match="coordinator, a process count"):
        distributed.init_distributed(*args, device="cpu")


def test_a_cuda_rank_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device visible"):
        distributed.init_distributed("localhost:1", 2, 0)
    assert distributed.init_method("h:1") == "tcp://h:1"
    assert distributed.init_method("file:///x") == "file:///x"
