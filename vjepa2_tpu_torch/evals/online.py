"""Probe evals inside pretraining (counterpart of `vjepa2_tpu/evals/online.py`;
reference `app/vjepa/utils.py:25-87` and `app/vjepa/train.py`'s
``eval_freq``).

The reference schedules separate eval jobs from the eval YAMLs listed under
the pretrain config's ``evals`` key. Here, as in JAX, the `Pretrainer` runs
them in process every ``meta.eval_freq`` epochs on the frozen EMA target
encoder: shallow probes (depth 1, the first 4 of the config's probe grid),
``ipe`` train steps an epoch, at the pretraining clips' geometry. Each eval
reads its config's data from disk where it names some (video manifests, an
ImageNet folder, EK100 annotations) and probes synthetic clips or images
otherwise, with a warning. The anticipation eval rolls the live pretraining
predictor forward.

The evals draw from generators of their own (the probes' `torch.Generator`,
the loaders' numpy streams) and build their own probe programs: a run with
evals gives the losses of a run without.
"""

from __future__ import annotations

from vjepa2_tpu_torch.core.config import read_yaml
from vjepa2_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)

ONLINE_PROBES = 4  # the first probes of a config's grid that train online (JAX's)


def make_online_eval(eval_cfg_paths, ipe: int = 20, epochs: int = 1):
    """The `Pretrainer`'s online eval of the eval configs at
    ``eval_cfg_paths``: a callable ``(encoder, epoch, predictor=None) ->
    {tag: metric}``, ``encoder`` the frozen target (its weights, geometry and
    heads), the metric each video or image config's top-1 and each
    anticipation config's action recall@k. A config of another family is
    skipped."""
    from vjepa2_tpu_torch.cli.eval import probe_configs_from_multihead

    cfgs = [(path, read_yaml(path)) for path in eval_cfg_paths or []]

    def parts(cfg):
        exp = cfg["experiment"]
        opt_c = exp["optimization"]
        probes = probe_configs_from_multihead(
            (opt_c.get("multihead_kwargs") or [{}])[:ONLINE_PROBES], ipe)
        return exp["data"], opt_c, exp.get("classifier", {}) or {}, probes

    def run_video(encoder, cfg, ctx) -> float:
        from vjepa2_tpu_torch.cli.eval import make_video_eval_loaders
        from vjepa2_tpu_torch.evals.video_classification import VideoClassificationEval

        data_c, opt_c, cls_c, probes = parts(cfg)
        num_classes = int(data_c.get("num_classes", 174))
        ev = VideoClassificationEval(
            encoder=encoder, num_classes=num_classes, probe_configs=probes,
            num_heads=int(cls_c.get("num_heads", encoder.num_heads)), probe_depth=1,
            total_steps=epochs * ipe)
        # the pretraining geometry: the encoder is built for it
        train, val = make_video_eval_loaders(
            data_c, int(opt_c.get("batch_size", 2)), encoder.num_frames, encoder.img_size[0], 1,
            num_classes, ipe, shard=ctx.get("shard"))
        return ev.run(train, val, epochs=epochs)["top1"]

    def run_image(encoder, cfg, ctx) -> float:
        from vjepa2_tpu_torch.cli.eval import make_image_eval_loaders
        from vjepa2_tpu_torch.evals.image_classification import ImageClassificationEval

        data_c, opt_c, cls_c, probes = parts(cfg)
        num_classes = int(data_c.get("num_classes", 1000))
        ev = ImageClassificationEval(
            encoder=encoder, num_classes=num_classes, probe_configs=probes,
            num_heads=int(cls_c.get("num_heads", encoder.num_heads)), probe_depth=1,
            total_steps=epochs * ipe,
            # images as as many frames as a tubelet holds, at least 2
            img_as_video_nframes=max(2, encoder.tubelet_size))
        train, val = make_image_eval_loaders(data_c, int(opt_c.get("batch_size", 4)),
                                             encoder.img_size[0], num_classes, ipe,
                                             shard=ctx.get("shard"))
        return ev.run(train, val, epochs=epochs)["top1"]

    def run_anticipation(encoder, cfg, ctx) -> float:
        from vjepa2_tpu_torch.cli.eval import make_anticipation_loaders
        from vjepa2_tpu_torch.evals.action_anticipation import AnticipationEval

        predictor = ctx.get("predictor")
        if predictor is None:
            logger.info("online anticipation skipped: no live predictor given")
            return float("nan")
        data_c, opt_c, cls_c, probes = parts(cfg)
        hp = encoder.img_size[0] // encoder.patch_size
        sizes, valid_actions, (train, val) = make_anticipation_loaders(
            data_c, int(opt_c.get("batch_size", 2)), encoder.num_frames, encoder.img_size[0],
            ipe, default_workers=0, shard=ctx.get("shard"),
            synthetic_labels=tuple(int(data_c.get(k, d)) for k, d in (
                ("num_verbs", 5), ("num_nouns", 7), ("num_actions", 9))))
        ev = AnticipationEval(
            encoder, predictor, *sizes,
            frames_per_second=float(data_c.get("frames_per_second", 4)), probe_configs=probes,
            total_steps=epochs * ipe, num_heads=int(cls_c.get("num_heads", encoder.num_heads)),
            grid_size=hp, h_patches=hp, w_patches=hp)
        for _ in range(epochs):
            for batch in train:
                ev.train_batch(*batch)
        result = ev.evaluate(val, k=int(opt_c.get("recall_k", 5)),
                             valid_action_classes=valid_actions)
        return float(result["action"]["recall"])

    runners = {"video_classification_frozen": run_video,
               "image_classification_frozen": run_image,
               "action_anticipation_frozen": run_anticipation}

    def online_eval(encoder, epoch: int, **ctx) -> dict:
        """``ctx``: ``predictor`` (the live one) and ``shard`` = (ways, index),
        the data group this rank reads its share of the eval data in."""
        results = {}
        for path, cfg in cfgs:
            name = cfg.get("eval_name", "video_classification_frozen")
            if name not in runners:
                logger.info("online eval: skipping %s (family %r has no inline runner)",
                            path, name)
                continue
            results[cfg.get("tag", path)] = runners[name](encoder, cfg, ctx)
        return results

    return online_eval
