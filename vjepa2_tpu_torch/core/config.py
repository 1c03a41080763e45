"""Typed config system, YAML-surface-compatible with the reference
(a copy of `vjepa2_tpu/core/config.py`, which needs no jax, but importing
anything of the JAX package imports jax, which the port never does).

The reference parses raw YAML into nested dicts with zero validation
(`app/vjepa/train.py:59-143`). Here each section becomes a dataclass with
defaults matching the reference's ``args.get(key, default)`` calls, so
reference config trees (`configs/train/...yaml`) load mechanically.
``yaml`` is imported only where a file is read (`from_yaml`, `load_config`):
`PretrainConfig.from_dict` needs nothing beyond the standard library.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


def _filter_kwargs(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclass
class DataConfig:
    dataset_type: str = "VideoDataset"
    datasets: list = field(default_factory=list)
    datasets_weights: Optional[list] = None
    batch_size: int = 24
    crop_size: int = 256
    patch_size: int = 16
    dataset_fpcs: list = field(default_factory=lambda: [16])
    tubelet_size: int = 2
    fps: int = 4
    num_workers: int = 4
    persistent_workers: bool = True
    pin_mem: bool = True
    # ship uint8 clips through collate/IPC/H2D and normalize inside the jit
    # step (4x less host memory traffic; fused into patch-embed by XLA)
    normalize_on_device: bool = False
    # droid (reference `configs/train/vitg16/droid-256px-8f.yaml:9-21`)
    camera_views: list = field(default_factory=lambda: ["left_mp4_path", "right_mp4_path"])
    camera_frame: bool = False
    stereo_view: bool = False


@dataclass
class DataAugConfig:
    auto_augment: bool = False
    motion_shift: bool = False
    random_resize_aspect_ratio: tuple = (0.75, 1.35)
    random_resize_scale: tuple = (0.3, 1.0)
    horizontal_flip: bool = True
    reprob: float = 0.0


@dataclass
class LossConfig:
    loss_exp: float = 1.0
    auto_steps: int = 1  # droid: AR rollout steps
    normalize_reps: bool = True


@dataclass
class ModelConfig:
    model_name: str = "vit_base"
    pred_depth: int = 12
    pred_embed_dim: int = 384
    pred_num_heads: Optional[int] = None
    uniform_power: bool = True
    use_mask_tokens: bool = True
    zero_init_mask_tokens: bool = True
    use_rope: bool = False
    use_silu: bool = False
    wide_silu: bool = True
    use_activation_checkpointing: bool = False
    # remat policy under activation checkpointing (models/modules.py:
    # resolve_remat_policy): 'full' recomputes everything; 'save_attn'
    # keeps the flash kernels' (out, lse) so the bwd never re-runs the
    # attention forward — the dominant recompute at 64f cooldown shapes
    remat_policy: Optional[str] = None
    use_extrinsics: bool = False  # droid
    max_num_frames: int = 512  # droid
    # TPU-native switches (beyond the reference's use_sdpa flag,
    # `src/models/utils/modules.py:243`): Pallas flash attention and
    # ring-attention context parallelism over the mesh 'model' axis
    use_flash: bool = False
    context_parallel: bool = False


@dataclass
class MetaConfig:
    seed: int = 234
    dtype: str = "bfloat16"
    eval_freq: int = 100
    load_checkpoint: bool = False
    read_checkpoint: Optional[str] = None
    save_every_freq: int = 50
    use_sdpa: bool = True


@dataclass
class OptimizationConfig:
    lr: float = 6.25e-4
    start_lr: float = 2e-4
    final_lr: float = 1e-6
    warmup: float = 40
    epochs: int = 300
    ipe: Optional[int] = None
    ipe_scale: float = 1.25
    weight_decay: float = 0.04
    final_weight_decay: float = 0.4
    ema: tuple = (0.998, 1.0)
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    # reference within-step multi-fpc loss composition: average every
    # (fpc-bucket x mask-config) pair inside ONE optimizer step
    # (`app/vjepa/train.py:425-435`); off = one fpc bucket per step
    # (alternating), the jit-friendly default
    multifpc_within_step: bool = False
    # split each batch into N sequential microbatches per optimizer step
    # (gradients averaged before ONE update); batch_size must divide evenly
    grad_accum: int = 1
    # droid extras
    anneal: Optional[float] = None
    enc_lr_scale: float = 1.0
    # cooldown/anneal phase (reference `configs/train/*/cooldown-*.yaml`):
    # resume the decay leg from a pretrain checkpoint
    is_anneal: bool = False
    anneal_ckpt: Optional[str] = None
    resume_anneal: bool = False


@dataclass
class MeshSection:
    data: int = -1
    fsdp: int = 1
    model: int = 1
    # pipeline parallelism (core/pipeline.py): number of GPipe stages the
    # encoder's block stack splits into, and microbatches streamed through
    # them per forward (bubble fraction = (pipe-1)/(microbatches+pipe-1))
    pipe: int = 1
    pipe_microbatches: int = 4


@dataclass
class PretrainConfig:
    app: str = "vjepa"
    folder: str = "./runs/default"
    evals: list = field(default_factory=list)  # eval YAMLs run online at eval_freq
    data: DataConfig = field(default_factory=DataConfig)
    data_aug: DataAugConfig = field(default_factory=DataAugConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    mask: list = field(default_factory=list)  # raw list of mask-config dicts
    model: ModelConfig = field(default_factory=ModelConfig)
    meta: MetaConfig = field(default_factory=MetaConfig)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    mesh: MeshSection = field(default_factory=MeshSection)

    @classmethod
    def from_dict(cls, d: dict) -> "PretrainConfig":
        return cls(
            app=d.get("app", "vjepa"),
            folder=d.get("folder", "./runs/default"),
            evals=d.get("evals", []) or [],
            data=DataConfig(**_filter_kwargs(DataConfig, d.get("data", {}) or {})),
            data_aug=DataAugConfig(**_filter_kwargs(DataAugConfig, d.get("data_aug", {}) or {})),
            loss=LossConfig(**_filter_kwargs(LossConfig, d.get("loss", {}) or {})),
            mask=d.get("mask", []) or [],
            model=ModelConfig(**_filter_kwargs(ModelConfig, d.get("model", {}) or {})),
            meta=MetaConfig(**_filter_kwargs(MetaConfig, d.get("meta", {}) or {})),
            optimization=OptimizationConfig(
                **_filter_kwargs(OptimizationConfig, d.get("optimization", {}) or {})
            ),
            mesh=MeshSection(**_filter_kwargs(MeshSection, d.get("mesh", {}) or {})),
        )

    @classmethod
    def from_yaml(cls, path: str) -> "PretrainConfig":
        return cls.from_dict(read_yaml(path))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def read_yaml(path: str) -> dict:
    """A YAML file's mapping (PyYAML, imported here)."""
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def load_config(path: str) -> PretrainConfig:
    return PretrainConfig.from_yaml(path)
