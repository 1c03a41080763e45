"""The port's requeue launcher and cluster submitter (`cli/launch.py`,
`cli/submit.py`) against the JAX package's (`vjepa2_tpu/cli/launch.py`,
`vjepa2_tpu/cli/submit.py`).

* The supervisor on a stub child (a Python one-liner counting its starts in
  ``tmp_path``): it requeues on exit 75 and on SIGTERM, stops at exit 0,
  gives up on any other code (which it returns) and after
  ``--max-requeues``.
* `render_sbatch` and `render_jobset` against JAX's renderings of the same
  ``cluster:`` sections (JAX's `tests/cli/test_submit.py` config and two
  more): the texts differ only on the lines `cli.submit`'s docstring names
  (one task a GPU, the GPU request, the port's launcher, torchrun in the
  pod); the rendered JobSet's environment resolves to JAX's rendezvous.
* ``main --dry-run`` stamps the run folder for both backends.
"""

import signal
import sys

import pytest
import yaml

from vjepa2_tpu_torch.cli import launch, submit
from vjepa2_tpu_torch.core.distributed import resolve_cluster

CFGS = [
    {"app": "vjepa", "nodes": 16, "folder": "/tmp/unused",
     "cluster": {"account": "acct", "partition": "tpu", "mem": "200G"}},
    {"app": "vjepa_droid", "cluster": {"nodes": 2, "time": "1:00:00", "gpus_per_node": 4,
                                       "image": "reg/img:1", "namespace": "ns"}},
    {"app": "vjepa", "cluster": {"backend": "gke", "cpus_per_task": 8}},
]
FNAME = "configs/train/vitl16/pretrain-256px-16f.yaml"


def _stub(tmp_path, codes):
    """A child that exits with ``codes[n]`` on its n-th start (a negative
    code: killed by that signal); its starts are counted in a file."""
    count = tmp_path / "starts"
    count.write_text("0")
    script = (f"import os, signal, sys; p = {str(count)!r}; n = int(open(p).read()); "
              f"open(p, 'w').write(str(n + 1)); c = {codes!r}[n]; "
              "os.kill(os.getpid(), -c) if c < 0 else sys.exit(c)")
    return [sys.executable, "-c", script], count


@pytest.mark.parametrize("codes, rc, starts", [
    ([75, 75, 0], 0, 3),                      # preempted twice, then done
    ([-signal.SIGTERM, 0], 0, 2),             # killed by SIGTERM: requeued
    ([75, 3, 0], 3, 2),                       # a failure propagates
    ([75, 75, 75, 0], 1, 3),                  # out of requeues (--max-requeues 2)
])
def test_supervisor_requeues_preemptions_only(tmp_path, codes, rc, starts):
    cmd, count = _stub(tmp_path, codes)
    got = launch.main(["--max-requeues", "2", "--requeue-delay", "0", "--fname", "x.yaml"],
                      cmd_prefix=cmd)
    assert got == rc and int(count.read_text()) == starts


def test_supervisor_passes_arguments_through(tmp_path):
    seen = tmp_path / "argv"
    cmd = [sys.executable, "-c",
           f"import sys; open({str(seen)!r}, 'w').write(' '.join(sys.argv[1:]))"]
    assert launch.main(["--fname", "a.yaml", "--epochs", "2"], cmd_prefix=cmd) == 0
    assert seen.read_text() == "--fname a.yaml --epochs 2"
    assert launch.MAIN == "vjepa2_tpu_torch.cli.main"


@pytest.mark.parametrize("cfg", CFGS)
def test_sbatch_differs_from_jax_only_on_the_named_lines(cfg):
    from vjepa2_tpu.cli import submit as jsubmit

    got = submit.render_sbatch(cfg, FNAME, "/runs/x").splitlines()
    want = jsubmit.render_sbatch(cfg, FNAME, "/runs/x").splitlines()
    gpus = submit.cluster_section(cfg)["gpus_per_node"]
    named = {
        "#SBATCH --ntasks-per-node=1": f"#SBATCH --ntasks-per-node={gpus}",
        "srun python -m vjepa2_tpu.cli.launch --fname /runs/x/config.yaml":
            "srun python -m vjepa2_tpu_torch.cli.launch --fname /runs/x/config.yaml",
    }
    expected = [named.get(line, line) for line in want]
    expected.insert(expected.index(f"#SBATCH --ntasks-per-node={gpus}") + 1,
                    f"#SBATCH --gpus-per-node={gpus}")
    assert got == expected


@pytest.mark.parametrize("cfg", CFGS)
def test_jobset_differs_from_jax_only_on_the_named_fields(cfg):
    from vjepa2_tpu.cli import submit as jsubmit

    got = yaml.safe_load(submit.render_jobset(cfg, FNAME, "/runs/x"))
    want = yaml.safe_load(jsubmit.render_jobset(cfg, FNAME, "/runs/x"))
    c = submit.cluster_section(cfg)
    pod = want["spec"]["replicatedJobs"][0]["template"]["spec"]["template"]["spec"]
    pod["nodeSelector"] = {"cloud.google.com/gke-accelerator": c["accelerator"]}
    box = pod["containers"][0]
    box["resources"] = {"limits": {"nvidia.com/gpu": c["gpus_per_node"]}}
    coord = dict((e["name"], e["value"]) for e in box["env"])["COORDINATOR_ADDRESS"]
    box["command"] = ["bash", "-c", (
        f"exec torchrun --nnodes {c['nodes']} --nproc-per-node {c['gpus_per_node']} "
        f"--node-rank $JOB_COMPLETION_INDEX --master-addr {coord} --master-port 37129 "
        "-m vjepa2_tpu_torch.cli.launch --fname /runs/x/config.yaml")]
    assert got == want


def test_jobset_rendezvous_roundtrip():
    """The env the rendered JobSet gives a pod resolves as JAX's does; the
    ranks torchrun starts in it resolve through torchrun's names."""
    m = yaml.safe_load(submit.render_jobset(CFGS[0], "pretrain-256px-16f.yaml", "/runs/x"))
    job = m["spec"]["replicatedJobs"][0]["template"]["spec"]
    assert job["parallelism"] == 16
    env = {e["name"]: e["value"] for e in job["template"]["spec"]["containers"][0]["env"]}
    env["JOB_COMPLETION_INDEX"] = "5"
    assert resolve_cluster(env) == (env["COORDINATOR_ADDRESS"] + ":37129", 16, 5, 0)
    env.update(MASTER_ADDR=env["COORDINATOR_ADDRESS"], MASTER_PORT="37129",
               WORLD_SIZE="128", RANK="41", LOCAL_RANK="1")
    assert resolve_cluster(env) == (env["COORDINATOR_ADDRESS"] + ":37129", 128, 41, 1)


@pytest.mark.parametrize("backend, manifest", [("slurm", "job.sbatch"), ("gke", "jobset.yaml")])
def test_dry_run_stamps_the_run_folder(tmp_path, backend, manifest):
    cfg = dict(CFGS[0], folder=str(tmp_path / "runs"))
    fname = tmp_path / "cfg.yaml"
    fname.write_text(yaml.safe_dump(cfg))
    assert submit.main(["--fname", str(fname), "--backend", backend, "--dry-run"]) == 0
    (run_dir,) = (tmp_path / "runs").iterdir()
    names = {p.name for p in run_dir.iterdir()}
    assert {manifest, "config.yaml", "params-vjepa.yaml", "git-info.txt"} <= names
    assert yaml.safe_load((run_dir / "config.yaml").read_text())["folder"] == str(run_dir)
    assert "_" not in submit.job_name(cfg, "some_config_name.yaml")
