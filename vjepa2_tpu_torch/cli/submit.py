"""Cluster job submission (counterpart of `vjepa2_tpu/cli/submit.py`;
reference `app/main_distributed.py`).

The reference submits through submitit: it timestamps a run folder,
snapshots params and git info, and submits one task per GPU with SLURM
resources read from the config header (`main_distributed.py:113-172`).
``submit`` renders a scheduler manifest from the config's ``cluster:``
section, an **sbatch script** (SLURM) or a **JobSet YAML** (Kubernetes),
stamps the run folder with provenance, and hands the manifest to ``sbatch``
/ ``kubectl`` when present (``--dry-run`` renders only).

Rendezvous needs no extra plumbing: every task runs ``cli.launch`` (the
requeue supervisor around ``cli.main``), and
`core.distributed.resolve_cluster` reads its rank from the scheduler (SLURM's
``SLURM_PROCID`` / ``SLURM_NTASKS`` / ``SLURM_LOCALID``, or torchrun's
environment in a JobSet pod).

The renderings differ from JAX's for the same ``cluster:`` section on these
lines only:

* sbatch: ``#SBATCH --ntasks-per-node`` is ``gpus_per_node`` (JAX: 1, one
  process a TPU host; here one task a GPU, as submitit's), an added
  ``#SBATCH --gpus-per-node`` line, and the ``srun`` line runs
  ``vjepa2_tpu_torch.cli.launch``;
* JobSet: the pod's ``nodeSelector`` is ``cloud.google.com/gke-accelerator:
  <accelerator>`` (JAX: the TPU accelerator and topology), its
  ``resources.limits`` are ``nvidia.com/gpu: <gpus_per_node>`` (JAX:
  ``google.com/tpu``), and its ``command`` runs ``torchrun --nnodes
  <nodes> --nproc-per-node <gpus_per_node> --node-rank
  $JOB_COMPLETION_INDEX`` on the coordinator's port over
  ``vjepa2_tpu_torch.cli.launch`` (JAX: ``python -m vjepa2_tpu.cli.launch``),
  through ``bash -c`` so that the pod's index reaches torchrun.

Config section (all optional, defaults in `DEFAULTS`)::

  cluster:
    backend: slurm | gke
    nodes: 16                 # slurm: -N / gke: JobSet pods
    gpus_per_node: 8          # tasks (slurm) or torchrun ranks (gke) a node
    account: my-account       # slurm
    partition: gpu            # slurm
    time: "72:00:00"          # slurm walltime
    cpus_per_task: 16         # slurm
    mem: 200G                 # slurm per-node memory
    accelerator: nvidia-h100-80gb   # gke node selector
    image: my-registry/vjepa2:latest   # gke container image
    namespace: default        # gke

Usage:
  python -m vjepa2_tpu_torch.cli.submit --fname cfg.yaml [--dry-run] [--backend slurm|gke]
"""

from __future__ import annotations

import argparse
import datetime
import os
import shutil
import subprocess

import yaml

from vjepa2_tpu_torch.core.distributed import DEFAULT_COORDINATOR_PORT
from vjepa2_tpu_torch.core.logging import get_logger

logger = get_logger(__name__, force=True)

LAUNCH = "vjepa2_tpu_torch.cli.launch"

DEFAULTS = {
    "backend": "slurm",
    "nodes": 1,
    "gpus_per_node": 8,
    "account": None,
    "partition": None,
    "time": "72:00:00",
    "cpus_per_task": 16,
    "mem": None,
    "accelerator": "nvidia-h100-80gb",
    "image": None,
    "namespace": "default",
}


def cluster_section(cfg: dict) -> dict:
    out = dict(DEFAULTS)
    out.update(cfg.get("cluster") or {})
    # reference config headers carry `nodes:` at top level
    # (`configs/train/vitl16/pretrain-256px-16f.yaml:2`)
    if "nodes" in cfg and "nodes" not in (cfg.get("cluster") or {}):
        out["nodes"] = cfg["nodes"]
    return out


def job_name(cfg: dict, fname: str) -> str:
    base = os.path.splitext(os.path.basename(fname))[0]
    return f"vjepa2-{cfg.get('app', 'vjepa')}-{base}".replace("_", "-")[:60]


def render_sbatch(cfg: dict, fname: str, run_dir: str) -> str:
    """Pure function config -> sbatch script text (testable without SLURM):
    one task a GPU."""
    c = cluster_section(cfg)
    name = job_name(cfg, fname)
    lines = [
        "#!/bin/bash",
        f"#SBATCH --job-name={name}",
        f"#SBATCH --nodes={c['nodes']}",
        f"#SBATCH --ntasks-per-node={c['gpus_per_node']}",
        f"#SBATCH --gpus-per-node={c['gpus_per_node']}",
        f"#SBATCH --cpus-per-task={c['cpus_per_task']}",
        f"#SBATCH --time={c['time']}",
        f"#SBATCH --output={run_dir}/slurm-%j-%t.out",
        "#SBATCH --requeue",
        "#SBATCH --signal=TERM@120",  # SIGTERM 120s ahead -> PreemptionGuard checkpoints
    ]
    if c["account"]:
        lines.append(f"#SBATCH --account={c['account']}")
    if c["partition"]:
        lines.append(f"#SBATCH --partition={c['partition']}")
    if c["mem"]:
        lines.append(f"#SBATCH --mem={c['mem']}")
    lines += [
        "",
        "# rendezvous: resolve_cluster reads SLURM_PROCID/SLURM_NTASKS/nodelist",
        f"srun python -m {LAUNCH} --fname {run_dir}/config.yaml",
        "",
    ]
    return "\n".join(lines)


def render_jobset(cfg: dict, fname: str, run_dir: str) -> str:
    """Pure function config -> JobSet YAML (testable without a cluster):
    one pod a node, torchrun starting one rank a GPU in each; the JobSet
    controller sets JOB_COMPLETION_INDEX (torchrun's node rank), and
    NUM_PROCESSES / COORDINATOR_ADDRESS come from the rendered env, as in
    JAX's manifest."""
    c = cluster_section(cfg)
    name = job_name(cfg, fname)
    image = c["image"] or "python:3.11"
    coordinator = f"{name}-workers-0-0.{name}"
    torchrun = (f"exec torchrun --nnodes {c['nodes']} --nproc-per-node {c['gpus_per_node']} "
                f"--node-rank $JOB_COMPLETION_INDEX --master-addr {coordinator} "
                f"--master-port {DEFAULT_COORDINATOR_PORT} -m {LAUNCH} "
                f"--fname {run_dir}/config.yaml")
    manifest = {
        "apiVersion": "jobset.x-k8s.io/v1alpha2",
        "kind": "JobSet",
        "metadata": {"name": name, "namespace": c["namespace"]},
        "spec": {
            "failurePolicy": {"maxRestarts": 100},  # preemption requeue
            # the headless Service and pod DNS names must exist: the
            # coordinator's FQDN below resolves through them
            "network": {"enableDNSHostnames": True, "subdomain": name},
            "replicatedJobs": [{
                "name": "workers",
                "replicas": 1,
                "template": {
                    "spec": {
                        "parallelism": c["nodes"],
                        "completions": c["nodes"],
                        "backoffLimit": 0,
                        "template": {
                            "spec": {
                                "subdomain": name,
                                "restartPolicy": "Never",
                                "nodeSelector": {
                                    "cloud.google.com/gke-accelerator": c["accelerator"],
                                },
                                "containers": [{
                                    "name": "worker",
                                    "image": image,
                                    "command": ["bash", "-c", torchrun],
                                    "env": [
                                        {"name": "NUM_PROCESSES", "value": str(c["nodes"])},
                                        {"name": "COORDINATOR_ADDRESS", "value": coordinator},
                                    ],
                                    "resources": {
                                        "limits": {"nvidia.com/gpu": c["gpus_per_node"]}
                                    },
                                }],
                            }
                        },
                    }
                },
            }],
        },
    }
    return yaml.safe_dump(manifest, sort_keys=False)


def prepare_run_dir(cfg: dict, fname: str) -> str:
    """Timestamped run folder with config + provenance (reference
    `main_distributed.py:113-123,144-172`, minus the full code snapshot,
    which container images and git commits supersede)."""
    from vjepa2_tpu_torch.core.provenance import dump_provenance

    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    base = cfg.get("folder", "./runs/submit")
    run_dir = os.path.join(base, stamp)
    os.makedirs(run_dir, exist_ok=True)
    # the stamped config points its own `folder` at the run dir, so the
    # launched job's checkpoints and logs land next to the manifest
    stamped = dict(cfg)
    stamped["folder"] = run_dir
    with open(os.path.join(run_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(stamped, f, sort_keys=False)
    dump_provenance(run_dir, cfg, app=cfg.get("app", "vjepa"))
    return run_dir


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--fname", required=True)
    p.add_argument("--backend", choices=["slurm", "gke"], default=None,
                   help="override cluster.backend from the config")
    p.add_argument("--dry-run", action="store_true",
                   help="render + stamp the run dir, do not submit")
    args = p.parse_args(argv)

    with open(args.fname) as f:
        cfg = yaml.safe_load(f)
    backend = args.backend or cluster_section(cfg)["backend"]
    run_dir = prepare_run_dir(cfg, args.fname)

    if backend == "slurm":
        text = render_sbatch(cfg, args.fname, run_dir)
        path = os.path.join(run_dir, "job.sbatch")
        submit_cmd = ["sbatch", path]
    else:
        text = render_jobset(cfg, args.fname, run_dir)
        path = os.path.join(run_dir, "jobset.yaml")
        submit_cmd = ["kubectl", "apply", "-f", path]

    with open(path, "w") as f:
        f.write(text)
    logger.info("rendered %s manifest: %s", backend, path)

    if args.dry_run:
        print(path)
        return 0
    if shutil.which(submit_cmd[0]) is None:
        logger.error("%s not found on PATH; rerun with --dry-run or submit %s manually",
                     submit_cmd[0], path)
        return 1
    rc = subprocess.run(submit_cmd).returncode
    logger.info("%s -> rc=%d", " ".join(submit_cmd), rc)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
