"""Frozen-eval launcher (counterpart of `vjepa2_tpu/cli/eval.py`; reference
`evals/main.py` + `evals/scaffold.py`).

The config layout is the reference eval YAMLs': ``eval_name``,
``experiment.{classifier,data,optimization}``, ``model_kwargs``. The probe
grid (``multihead_kwargs``) trains as one `evals.probes.ProbeGrid`.

Usage:
  python -m vjepa2_tpu_torch.cli.eval --fname configs/eval/vitl/ssv2.yaml --synthetic-data
  python -m vjepa2_tpu_torch.cli.eval --fname configs/eval/vitl/ek100.yaml --epochs 1
  python -m vjepa2_tpu_torch.cli.eval --fname configs/eval/vitl/in1k.yaml --tiny --device cpu

One process on one card. ``--device`` is ``cuda`` unless given, and without
a card the run fails (`core.device.entry_device`). On the card the encoder
(and EK100's predictor) is built in bf16 with the flash kernels on
(``use_flash``), as the `Pretrainer` and the hub build theirs; on the CPU in
fp32 on the plain route. The probes compute in fp32 either way.

Data: the video evals read ``data.dataset_train`` / ``dataset_val`` (CSV or
``.npy`` manifests) from disk through `data.video_dataset.VideoDataset` and
`data.loader.DataLoader`, as JAX's `make_video_eval_loaders`; with the paths
left null the eval probes synthetic clips, with JAX's warning. The image
(``root``) and EK100 (``annotations_*``) paths are refused unless
``--synthetic-data`` is given: those loaders are not ported (ROADMAP A8c).
Checkpoints (``--checkpoint`` or ``model_kwargs.checkpoint``):
a torch file (a released ``.pt``: its ``target_encoder``, else ``encoder``,
else the whole file; or a `Pretrainer` step file, whose target encoder it
takes) or a `Pretrainer` checkpoint directory (its latest step); JAX's
Orbax checkpoints and the pipeline-parallel layout are refused (ROADMAP A12).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from vjepa2_tpu_torch.core.device import entry_device
from vjepa2_tpu_torch.core.logging import get_logger
from vjepa2_tpu_torch.evals.probes import ProbeConfig
from vjepa2_tpu_torch.models.vision_transformer import MODEL_REGISTRY

logger = get_logger(__name__)


def probe_configs_from_multihead(multihead_kwargs, ipe: int) -> list[ProbeConfig]:
    out = []
    for g in multihead_kwargs:
        fwd = g.get("final_weight_decay", g.get("final_wd"))
        out.append(ProbeConfig(
            lr=float(g.get("lr", g.get("ref_lr", 1e-3))),
            start_lr=float(g.get("start_lr", g.get("lr", 1e-3))),
            final_lr=float(g.get("final_lr", 0.0)),
            weight_decay=float(g.get("weight_decay", g.get("ref_wd", 0.0))),
            warmup_steps=int(float(g.get("warmup", 0.0)) * ipe),
            final_wd=float(fwd) if fwd is not None else None))
    return out


class SyntheticEvalLoader:
    """Class-dependent synthetic clips so probes have signal to learn (JAX's
    numpy draws from the same seeds)."""

    def __init__(self, batch_size, num_clips, fpc, crop, num_classes, batches, seed=0):
        self.rng = np.random.default_rng(seed)
        self.shape = (batch_size, num_clips, fpc, crop, crop, 3)
        self.num_classes = num_classes
        self.batches = batches
        self.fpc = fpc

    def __iter__(self):
        for _ in range(self.batches):
            labels = self.rng.integers(0, self.num_classes, size=self.shape[0])
            clips = self.rng.normal(size=self.shape).astype(np.float32) * 0.1
            clips += labels[:, None, None, None, None, None] / self.num_classes
            ci = np.tile(np.arange(self.fpc), (self.shape[0], self.shape[1], 1))
            yield clips, labels, ci


class Replay:
    """Iterates ``make()`` afresh on each pass: every epoch sees the same
    seeded batches (JAX keeps them in a list) and none stay in memory."""

    def __init__(self, make):
        self.make = make

    def __iter__(self):
        return iter(self.make())


def placement(device) -> tuple[torch.device, torch.dtype, bool]:
    """(device, compute dtype, use_flash): bf16 on the flash route on the
    card, fp32 on the plain route on the CPU (the hub's placement)."""
    from vjepa2_tpu_torch.hub.backbones import _placement

    device, dtype = _placement(device, None)
    return device, dtype, device.type == "cuda"


def resolve_checkpoint(path: str) -> str:
    """The torch checkpoint file that ``path`` names: the file itself, or a
    `Pretrainer` checkpoint directory's latest ``<step>.pt``. Directories
    without one (the JAX package's Orbax checkpoints) are refused."""
    from vjepa2_tpu_torch.core.checkpoint import CheckpointManager

    if not os.path.isdir(path):
        return path
    mgr = CheckpointManager(path)
    step = mgr.latest_step()
    if step is None:
        raise NotImplementedError(
            f"{path} holds no <step>.pt of the port's Pretrainer: the JAX package's Orbax "
            "checkpoints, its pipeline-parallel layout among them, are not read by the "
            "port (ROADMAP A12)")
    return mgr.path(step)


def load_encoder_state(path: str) -> dict:
    """The encoder state dict of a torch checkpoint (`resolve_checkpoint`):
    a released ``.pt`` or a `Pretrainer` step, ``target_encoder``, else
    ``encoder``, else the whole file. The pipeline-parallel layout is
    refused."""
    from vjepa2_tpu_torch.hub.backbones import load_checkpoint, module_state_dict

    ckpt = load_checkpoint(resolve_checkpoint(path))
    if "encoder_blocks" in ckpt or "encoder_blocks" in (ckpt.get("target_params") or {}):
        raise NotImplementedError("the pipeline-parallel checkpoint layout (stacked "
                                  "'encoder_blocks') is not ported (ROADMAP A12)")
    return module_state_dict(next((ckpt[k] for k in ("target_encoder", "encoder") if k in ckpt),
                                  ckpt))


def build_encoder(model_kwargs: dict, resolution: int, fpc: int, checkpoint=None,
                  out_layers=None, device="cuda"):
    """The frozen encoder of an eval config, in eval mode: the checkpoint's
    weights, else drawn from a `torch.Generator` seeded 0 (with a warning)."""
    device, dtype, use_flash = placement(device)
    pk = model_kwargs.get("pretrain_kwargs", {}) or {}
    if "encoder" in pk:  # reference nests encoder kwargs one level deeper
        pk = pk["encoder"]
    model_name = pk.get("model_name", model_kwargs.get("model_name", "vit_large"))
    enc = MODEL_REGISTRY[model_name](
        img_size=(resolution, resolution), num_frames=fpc,
        tubelet_size=pk.get("tubelet_size", 2), uniform_power=pk.get("uniform_power", True),
        use_rope=pk.get("use_rope", True), out_layers=tuple(out_layers) if out_layers else None,
        use_flash=use_flash, dtype=dtype, device=device)
    if checkpoint:
        enc.load_state_dict(load_encoder_state(checkpoint))
    else:
        logger.warning("no checkpoint given: using randomly-initialized encoder")
        enc.reset_parameters(torch.Generator(device=device).manual_seed(0))
    return enc.eval().requires_grad_(False)


def refuse_data_paths(data_c: dict, keys, synthetic: bool) -> None:
    """The image folders and EK100 annotations need the loaders of ROADMAP A8c."""
    named = [k for k in keys if data_c.get(k)]
    if named and not synthetic:
        raise NotImplementedError(
            f"the eval config names data on disk ({', '.join(named)}): its loader from disk "
            "is not ported (ROADMAP A8c, the rest of A8b: the video manifests are read); pass "
            "--synthetic-data to probe on synthetic clips")


def _warn_synthetic(data_c: dict, key: str, synthetic: bool) -> None:
    if not synthetic and not data_c.get(key):
        logger.warning(f"eval: no `data.{key}` in the eval config — probing on SYNTHETIC "
                       "clips; the logged metric is a smoke signal, NOT a benchmark number.")


def eval_collate(samples):
    """[(clips_list, label, clip_indices), ...] -> (clips [B, nc, T, S, S, 3],
    labels [B], clip_indices [B, nc, T]) (JAX's collate, `cli/eval.py:144`)."""
    clips = np.stack([np.stack(s[0]) for s in samples])
    labels = np.asarray([s[1] for s in samples])
    ci = np.stack([np.stack([np.asarray(c) for c in s[2]]) for s in samples])
    return clips, labels, ci


def make_video_eval_loaders(data_c, batch_size, fpc, res, num_clips, num_classes, ipe,
                            synthetic=False):
    """(train, val) loaders of a probe eval: ``data.dataset_train`` and
    ``dataset_val`` from disk (a `VideoDataset` with JAX's frame step and
    random-crop transform, flipped only in training; ``ipe`` train batches
    an epoch, the whole val manifest), else synthetic: ``ipe`` batches, then
    ``ipe // 4``. The batches come in the sampler's order."""
    if synthetic or not data_c.get("dataset_train"):
        _warn_synthetic(data_c, "dataset_train", synthetic)
        return (SyntheticEvalLoader(batch_size, num_clips, fpc, res, num_classes, ipe),
                SyntheticEvalLoader(batch_size, num_clips, fpc, res, num_classes,
                                    max(1, ipe // 4), seed=1))
    from vjepa2_tpu_torch.data.loader import DataLoader
    from vjepa2_tpu_torch.data.samplers import DistributedSampler
    from vjepa2_tpu_torch.data.transforms import VideoTransform
    from vjepa2_tpu_torch.data.video_dataset import VideoDataset

    def make(path, train):
        ds = VideoDataset(data_paths=[path], frames_per_clip=fpc,
                          frame_step=data_c.get("frame_step", 4), fps=None, num_clips=num_clips,
                          transform=VideoTransform(crop_size=res, horizontal_flip=train))
        sampler = DistributedSampler(len(ds), 1, 0, shuffle=train)
        return DataLoader(ds, sampler, batch_size, num_workers=data_c.get("num_workers", 4),
                          collate_fn=eval_collate, ordered=True,
                          epoch_len=ipe if train else None)

    return make(data_c["dataset_train"], True), make(data_c["dataset_val"], False)


def _extract(mdl_c: dict, wrapper_kwargs: dict, **modules):
    """The config's plugin wrapper (by ``module_name``), or None."""
    if not mdl_c.get("module_name"):
        return None
    from vjepa2_tpu_torch.evals import plugins

    return plugins.init_module(mdl_c["module_name"], **modules, **wrapper_kwargs)


def run_video_classification(cfg: dict, args) -> dict:
    from vjepa2_tpu_torch.evals.video_classification import VideoClassificationEval

    exp = cfg["experiment"]
    data_c, opt_c = exp["data"], exp["optimization"]
    cls_c = exp.get("classifier", {})
    mdl_c = cfg.get("model_kwargs", {})
    fpc = int(data_c.get("frames_per_clip", 16))
    res = int(data_c.get("resolution", 256))
    num_classes = int(data_c.get("num_classes", 174))
    num_clips = int(data_c.get("num_segments", 1))
    batch_size = int(opt_c.get("batch_size", 4))
    epochs = args.epochs or int(opt_c.get("num_epochs", 1))
    ipe = int(opt_c.get("ipe", 100))

    wrapper_kwargs = dict(mdl_c.get("wrapper_kwargs", {}) or {})
    encoder = build_encoder(mdl_c, res, fpc, args.checkpoint or mdl_c.get("checkpoint"),
                            out_layers=wrapper_kwargs.get("out_layers"), device=args.device)
    probes = probe_configs_from_multihead(opt_c.get("multihead_kwargs", [{}]), ipe)
    ev = VideoClassificationEval(
        encoder=encoder, num_classes=num_classes, probe_configs=probes,
        num_heads=int(cls_c.get("num_heads", encoder.num_heads)),
        probe_depth=int(cls_c.get("num_probe_blocks", 1)), total_steps=epochs * ipe,
        use_pos_embed=bool(wrapper_kwargs.get("use_pos_embed", False)),
        extract_fn=_extract(mdl_c, wrapper_kwargs, encoder=encoder))
    train_loader, val_loader = make_video_eval_loaders(data_c, batch_size, fpc, res, num_clips,
                                                       num_classes, ipe,
                                                       synthetic=args.synthetic_data)
    val_only = args.val_only or bool(cfg.get("val_only", False))
    probe_ckpt = mdl_c.get("probe_checkpoint")
    if val_only and probe_ckpt:
        ev.restore_probes(probe_ckpt)
    # one view in the val pass, as JAX's launcher (`cli/eval.py:226`)
    result = ev.run(train_loader, val_loader, epochs=0 if val_only else epochs)
    logger.info("top-1 %.4f (probe %d of %d); per-probe: %s", result["top1"],
                result["best_probe"], len(probes), np.round(result["top1_per_probe"], 4))
    print({"top1": result["top1"], "best_probe": result["best_probe"]})
    return result


def run_image_classification(cfg: dict, args) -> dict:
    """IN1K frozen probe (reference `evals/image_classification_frozen/eval.py`)."""
    from vjepa2_tpu_torch.evals.image_classification import ImageClassificationEval

    exp = cfg["experiment"]
    data_c, opt_c = exp["data"], exp["optimization"]
    cls_c = exp.get("classifier", {})
    mdl_c = cfg.get("model_kwargs", {})
    refuse_data_paths(data_c, ("root", "root_val"), args.synthetic_data)
    _warn_synthetic(data_c, "root", args.synthetic_data)
    res = int(data_c.get("resolution", 256))
    num_classes = int(data_c.get("num_classes", 1000))
    batch_size = int(opt_c.get("batch_size", 16))
    ipe = int(opt_c.get("ipe", 100))
    epochs = args.epochs or int(opt_c.get("num_epochs", 1))

    wrapper_kwargs = dict(mdl_c.get("wrapper_kwargs", {}) or {})
    # the reference replicates each image to N fake frames so the *video*
    # encoder tokenizes it (`image_classification_frozen/modelcustom/
    # vit_encoder.py:56-66`; the in1k configs use img_as_video_nframes 16/18)
    nframes = int(wrapper_kwargs.get("img_as_video_nframes", 2))
    encoder = build_encoder(mdl_c, res, nframes, args.checkpoint or mdl_c.get("checkpoint"),
                            device=args.device)
    probes = probe_configs_from_multihead(opt_c.get("multihead_kwargs", [{}]), ipe)
    ev = ImageClassificationEval(
        encoder=encoder, num_classes=num_classes, probe_configs=probes,
        num_heads=int(cls_c.get("num_heads", encoder.num_heads)),
        probe_depth=int(cls_c.get("num_probe_blocks", 1)), total_steps=epochs * ipe,
        img_as_video_nframes=nframes, extract_fn=_extract(mdl_c, wrapper_kwargs, encoder=encoder))

    def synth(batches, seed):
        r = np.random.default_rng(seed)
        for _ in range(batches):
            labels = r.integers(0, num_classes, size=batch_size)
            imgs = r.normal(size=(batch_size, res, res, 3)).astype(np.float32) * 0.1
            imgs += labels[:, None, None, None] / num_classes
            yield imgs, labels

    result = ev.run(Replay(lambda: synth(ipe, 0)), Replay(lambda: synth(max(1, ipe // 4), 1)),
                    epochs=epochs)
    logger.info("IN1K top-1 %.4f (best probe %d)", result["top1"], result["best_probe"])
    print({"top1": result["top1"], "best_probe": result["best_probe"]})
    return result


def build_predictor(encoder, res: int, fpc: int, checkpoint=None, device="cuda"):
    """The released predictor architecture (12 x 384, 12 heads, 10 mask
    tokens, RoPE) at the encoder's width: the ``predictor`` of the checkpoint
    (`resolve_checkpoint`, the file the encoder reads) where it holds one,
    else drawn from a generator seeded 1. JAX reads only a path ending in
    ``.pt``; the port reads every checkpoint as a torch file, so a
    `Pretrainer` directory gives its encoder and its predictor alike."""
    from vjepa2_tpu_torch.hub.backbones import load_checkpoint, module_state_dict
    from vjepa2_tpu_torch.models.predictor import vit_predictor

    device, dtype, use_flash = placement(device)
    pred = vit_predictor(img_size=(res, res), num_frames=fpc, tubelet_size=2,
                         embed_dim=encoder.embed_dim, predictor_embed_dim=384, depth=12,
                         num_heads=12, num_mask_tokens=10, use_mask_tokens=True, use_rope=True,
                         use_flash=use_flash, dtype=dtype, device=device)
    ckpt = load_checkpoint(resolve_checkpoint(checkpoint)) if checkpoint else {}
    if "predictor" in ckpt:
        pred.load_state_dict(module_state_dict(ckpt["predictor"]))
    else:
        logger.warning("no predictor in the checkpoint: using a randomly-initialized predictor")
        pred.reset_parameters(torch.Generator(device=device).manual_seed(1))
    return pred.eval().requires_grad_(False)


def run_action_anticipation(cfg: dict, args) -> dict:
    """EK100 anticipation (reference `evals/action_anticipation_frozen/eval.py`).

    The probes take ``classifier.num_heads``, else the encoder's heads: JAX
    leaves `AnticipationEval`'s default of 12, which does not divide ViT-L's
    1024 (its `CrossAttention` reshape fails; ROADMAP queue C)."""
    from vjepa2_tpu_torch.evals.action_anticipation import AnticipationEval

    exp = cfg["experiment"]
    data_c, opt_c = exp["data"], exp["optimization"]
    cls_c = exp.get("classifier", {}) or {}
    mdl_c = cfg.get("model_kwargs", {})
    refuse_data_paths(data_c, ("annotations_train", "annotations_val"), args.synthetic_data)
    _warn_synthetic(data_c, "annotations_train", args.synthetic_data)
    fpc = int(data_c.get("frames_per_clip", 16))
    res = int(data_c.get("resolution", 256))
    batch_size = int(opt_c.get("batch_size", 8))
    ipe = int(opt_c.get("ipe", 100))
    epochs = args.epochs or int(opt_c.get("num_epochs", 1))
    fps = float(data_c.get("frames_per_second", 4))

    ckpt = args.checkpoint or mdl_c.get("checkpoint")
    if ckpt:  # one file for both models, whatever step a directory gains meanwhile
        ckpt = resolve_checkpoint(ckpt)
    encoder = build_encoder(mdl_c, res, fpc, ckpt, device=args.device)
    predictor = build_predictor(encoder, res, fpc, ckpt, device=args.device)
    hp = res // 16

    nv, nn_, na = 5, 7, 9

    def synth(batches, seed):
        rr = np.random.default_rng(seed)
        for _ in range(batches):
            labels = rr.integers(0, nv, size=batch_size)
            clips = rr.normal(size=(batch_size, fpc, res, res, 3)).astype(np.float32) * 0.1
            clips += labels[:, None, None, None, None] / nv
            yield clips, np.ones(batch_size, np.float32), labels, labels % nn_, labels % na

    # the full probe grid (reference: one classifier per multihead entry,
    # `action_anticipation_frozen/eval.py:125,230`)
    probes = probe_configs_from_multihead(opt_c.get("multihead_kwargs", [{}]), ipe)
    ev = AnticipationEval(
        encoder, predictor, num_verbs=nv, num_nouns=nn_, num_actions=na,
        frames_per_second=fps, grid_size=hp, h_patches=hp, w_patches=hp, probe_configs=probes,
        total_steps=epochs * ipe, num_heads=int(cls_c.get("num_heads", encoder.num_heads)))
    val_only = args.val_only or bool(cfg.get("val_only", False))
    probe_ckpt = mdl_c.get("probe_checkpoint")
    if val_only:
        if not probe_ckpt:
            raise ValueError("val_only anticipation needs model_kwargs.probe_checkpoint")
        ev.restore_probes(probe_ckpt)
    else:
        loss = float("nan")  # stays NaN if the loader yields nothing
        for epoch in range(epochs):
            for batch in synth(ipe, 0):
                loss = ev.train_batch(*batch)
            logger.info("anticipation epoch %d loss %.4f", epoch, loss)
        if probe_ckpt:
            ev.save_probes(probe_ckpt)
    result = ev.evaluate(synth(max(1, ipe // 4), 1), k=int(opt_c.get("recall_k", 5)))
    logger.info("anticipation: %s", result)
    print({k: result[k]["recall"] for k in ("verb", "noun", "action")})
    return result


def shrink_config(cfg: dict) -> dict:
    """Scale a real eval config down to vit_tiny/64px/2-probe for smoke runs;
    the dispatch wiring (module_name, out_layers, grids) is preserved. As
    JAX's, it copies the top level only and edits the nested sections in
    place."""
    cfg = dict(cfg)
    exp = cfg.get("experiment", {})
    data_c = exp.get("data", {})
    opt_c = exp.get("optimization", {})
    data_c.update(resolution=64, frames_per_clip=4, num_segments=1, frame_step=1)
    data_c["num_classes"] = min(int(data_c.get("num_classes", 10)), 10)
    opt_c.update(batch_size=2, num_epochs=1, ipe=2)
    opt_c["multihead_kwargs"] = (opt_c.get("multihead_kwargs") or [{}])[:2]
    mdl = cfg.get("model_kwargs", {}) or {}
    pk = mdl.get("pretrain_kwargs", {}) or {}
    if "encoder" in pk:
        pk = pk["encoder"]
    pk["model_name"] = "vit_tiny"
    mdl["pretrain_kwargs"] = pk
    mdl["checkpoint"] = None
    wk = mdl.get("wrapper_kwargs", {}) or {}
    if wk.get("out_layers"):
        wk["out_layers"] = [4, 8, 11]  # vit_tiny has 12 blocks
    if "img_as_video_nframes" in wk:
        wk["img_as_video_nframes"] = 2
    return cfg


EVALS = {
    "video_classification_frozen": run_video_classification,
    "image_classification_frozen": run_image_classification,
    "action_anticipation_frozen": run_action_anticipation,
}


def main(argv=None):
    from vjepa2_tpu_torch.core.config import read_yaml

    p = argparse.ArgumentParser()
    p.add_argument("--fname", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--synthetic-data", action="store_true")
    p.add_argument("--val-only", action="store_true")
    p.add_argument("--tiny", action="store_true",
                   help="smoke mode: shrink model/resolution/ipe but keep the exact "
                        "config-driven dispatch path (plugin module_name, probe grid, ...)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--coordinator", default=None, help="multi-host coordinator address")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    args = p.parse_args(argv)
    get_logger(force=True)
    if args.coordinator or (args.num_processes or 1) > 1 or (args.process_id or 0) > 0:
        raise SystemExit("several processes (--coordinator, --num-processes, --process-id) are "
                         "not ported: the port evaluates on one card (ROADMAP A12)")
    args.device = entry_device(args.device)

    cfg = read_yaml(args.fname)
    if args.tiny:
        cfg = shrink_config(cfg)
        args.synthetic_data = True
    name = cfg.get("eval_name", "video_classification_frozen")
    if name not in EVALS:
        raise SystemExit(f"unknown eval_name '{name}'; available: {', '.join(EVALS)}")
    return EVALS[name](cfg, args)


if __name__ == "__main__":
    main()
