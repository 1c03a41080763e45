"""CLI launcher (counterpart of `vjepa2_tpu/cli/main.py`; reference
`app/main.py`).

One process a card, on one card or several. ``--coordinator host:port``,
``--num-processes`` and ``--process-id``, or the scheduler's environment
(torchrun's ``MASTER_ADDR`` / ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK``,
SLURM's tasks, a JobSet's index), start a process group
(`core.distributed.init_distributed`: NCCL on the card, each rank on
``cuda:LOCAL_RANK``; gloo with ``--device cpu``), which the run leaves at
its end; the config's ``mesh`` lays the ranks out (`train.loop`). App
dispatch is config-driven over an explicit registry, as in JAX.

Usage:
  python -m vjepa2_tpu_torch.cli.main --fname configs/train/vith16/pretrain-256px-16f.yaml
  python -m vjepa2_tpu_torch.cli.main --fname cfg.yaml --epochs 1 --synthetic-data
  python -m vjepa2_tpu_torch.cli.main --fname cfg.yaml --device cpu
  python -m vjepa2_tpu_torch.cli.main --fname configs/train/vitg16/droid-256px-8f.yaml --epochs 1
  torchrun --nproc-per-node 8 -m vjepa2_tpu_torch.cli.main --fname cfg.yaml
  torchrun --nproc-per-node 8 -m vjepa2_tpu_torch.cli.main --fname configs/train/smoke-pipeline.yaml

Apps: ``vjepa`` (masked pretraining, `train.loop.Pretrainer`) and
``vjepa_droid`` (action-conditioned post-training, `train.droid_loop.DroidTrainer`).
A config's ``data.datasets`` (CSV or ``.npy`` video manifests) trains from
disk; ``--synthetic-data`` (or ``datasets: []``) trains on synthetic clips.
``--device`` is ``cuda`` unless given: without a card the run fails
(`core.device.entry_device`). Under ``vjepa``, SIGTERM checkpoints the run and
exits 75 (the wrapper requeues it; the restarted run resumes with
``meta.load_checkpoint``); JAX's ``vjepa_droid`` installs no such guard, nor
does the port's.
"""

from __future__ import annotations

import argparse
import pprint

from vjepa2_tpu_torch.core import distributed
from vjepa2_tpu_torch.core.config import PretrainConfig, read_yaml
from vjepa2_tpu_torch.core.device import entry_device
from vjepa2_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)


def run_vjepa(cfg: PretrainConfig, args) -> dict:
    from vjepa2_tpu_torch.core.provenance import PreemptionGuard
    from vjepa2_tpu_torch.train.loop import Pretrainer

    trainer = Pretrainer(cfg, synthetic_data=args.synthetic_data, device=args.device)
    guard = PreemptionGuard()
    try:
        result = trainer.run(epochs=args.epochs, preemption_guard=guard)
    finally:
        # the process may go on (a library call, a test run): SIGTERM must
        # stop it again once this run is over
        guard.uninstall()
    if result.get("preempted"):
        # non-zero exit signals the batch wrapper to requeue; the restarted
        # run resumes from the checkpoint just written (load_checkpoint)
        raise SystemExit(75)  # EX_TEMPFAIL
    return result


def run_vjepa_droid(cfg: PretrainConfig, args) -> dict:
    """AC post-training (`train.droid_loop.DroidTrainer`); ``meta.read_checkpoint``
    names a pretrained V-JEPA 2 torch checkpoint whose ``target_encoder``,
    else ``encoder``, entry becomes the frozen target (JAX `cli/main.py:39-50`)."""
    from vjepa2_tpu_torch.train.droid_loop import DroidTrainer

    enc_state = None
    if cfg.meta.read_checkpoint:
        from vjepa2_tpu_torch.hub.backbones import encoder_state_dict

        enc_state = encoder_state_dict(cfg.meta.read_checkpoint,
                                       keys=("target_encoder", "encoder"))
    trainer = DroidTrainer(cfg, enc_state=enc_state, synthetic_data=args.synthetic_data,
                           device=args.device)
    return trainer.run(epochs=args.epochs)


APPS = {"vjepa": run_vjepa, "vjepa_droid": run_vjepa_droid}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--fname", required=True, help="YAML config (reference-compatible sections)")
    p.add_argument("--app", default=None, help="override the config's app name")
    p.add_argument("--epochs", type=int, default=None, help="override epoch count")
    p.add_argument("--synthetic-data", action="store_true", help="run on synthetic clips")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--coordinator", default=None,
                   help="the process group's address, host:port (or a file:// store)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    args = p.parse_args(argv)
    get_logger(force=True)
    args.device = entry_device(args.device)
    owned = not distributed.initialized()
    rank, world = distributed.init_distributed(args.coordinator, args.num_processes,
                                               args.process_id, device=args.device)
    if world > 1:
        logger.info("process %d / %d", rank, world)
    try:
        out = _run(args)
    except BaseException:
        if owned:
            distributed.destroy(meet=False)
        raise
    if owned:
        distributed.destroy()
    return out


def _run(args):
    raw = read_yaml(args.fname)
    cfg = PretrainConfig.from_dict(raw)
    app = args.app or cfg.app
    if app not in APPS:
        raise SystemExit(f"unknown app '{app}'; available: {', '.join(APPS)}")
    cfg.app = app
    logger.info("loaded config:\n%s", pprint.pformat(raw)[:2000])
    from vjepa2_tpu_torch.core.provenance import dump_provenance

    if distributed.is_main_process():
        dump_provenance(cfg.folder, raw, app=app)
    result = APPS[app](cfg, args)
    logger.info("done: %s", result)
    return result


if __name__ == "__main__":
    main()
