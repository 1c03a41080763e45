"""Serving export: `torch.export` programs of the encoder and the world model
(counterpart of `vjepa2_tpu/hub/export.py`).

The reference serves models through `torch.hub` (load the repo and run); the
deployment story here is ahead-of-time export: the forward is traced once
with `torch.export` and saved, and a serving process loads and calls it with
no model code. The graph holds the port's attention and LayerNorm forwards as
the dispatcher ops of `vjepa2_tpu_torch.ops` (``torch.ops.vjepa2.flash_fwd_dn``,
``flash_fwd_bhnd``, ``ln_qkv``, ``ln_mlp``), each one node, which launch the
hand-written kernels on the card and their plain versions on the CPU; their
fake kernels are what lets `torch.export` trace them. Loading imports
`vjepa2_tpu_torch.ops` (which registers those ops) and nothing of
`vjepa2_tpu_torch.models`.

Symbolic batch: ``batch="B"`` exports dim 0 of the clips as
``torch.export.Dim("B", min=1)``, so one program serves every batch size; it
is traced at a batch of 2, since a trace at 1 would specialise it. Frames and
resolution are baked in, as V-JEPA deployments fix the clip geometry per
endpoint.

Where JAX differs (ROADMAP queue C): the weights ride in the program (one
``.pt2`` file, `torch.export.save`) in place of StableHLO plus a msgpack
param tree; JAX's lowering ``platforms`` become the device the program is
loaded onto (``device=``, the card by default: a program traced on the CPU
holds the same op nodes and launches the kernels once moved there,
`torch.export.passes.move_to_device_pass`); and the plan's noise is an input
of the program, drawn by the serving side from the seed
(`ServingWorldModel.plan`), where JAX builds its PRNG key from an int32 seed
inside the program.

Format on disk (a directory):
    encode.pt2   — the encoder's program (or the world model's encode)
    plan.pt2     — the world model's CEM plan
    meta.json    — clip geometry, dtypes, and the world model's preprocessor

Usage:
    from vjepa2_tpu_torch.hub import backbones, export
    enc, _ = backbones.vjepa2_vit_large()
    export.export_encoder(enc, "/srv/vjepa2-l", batch="B")

    # serving process (no model code imported):
    fn, meta = export.load_encoder("/srv/vjepa2-l")
    feats = fn(clips)   # [B, T, H, W, 3] -> [B, N, D]
"""

from __future__ import annotations

import collections
import json
import os
from typing import Optional

import numpy as np
import torch

ENCODE_PROGRAM = "encode.pt2"
PLAN_PROGRAM = "plan.pt2"
META = "meta.json"


class _Program(torch.nn.Module):
    """``fn`` as a module whose parameters are ``model``'s, so that
    `torch.export` lifts the weights ``fn`` reaches through it."""

    def __init__(self, fn, model: torch.nn.Module):
        super().__init__()
        self.model = model
        self._fn = fn

    def forward(self, *args):
        return self._fn(*args)


def _export(module: torch.nn.Module, args: tuple, dynamic_shapes=None):
    """`torch.export.export` of a forward-only program: gradients off, so the
    kernels' `autograd.Function`s trace as their forward ops."""
    with torch.no_grad():
        return torch.export.export(module, args, dynamic_shapes=dynamic_shapes)


def _write_meta(out_dir: str, meta: dict) -> None:
    with open(os.path.join(out_dir, META), "w") as f:
        json.dump(meta, f, indent=1)


def _read_meta(out_dir: str) -> dict:
    with open(os.path.join(out_dir, META)) as f:
        return json.load(f)


def _load_program(path: str, device: torch.device) -> torch.nn.Module:
    """The saved program as a callable module on ``device``. The ops are
    registered first: a graph that names them does not deserialise without
    them. The weights keep the flags they were saved with (``requires_grad``,
    as the factories build them): `torch.matmul` splits a batched product
    differently for an operand that requires grad, so freezing them here
    would round differently from the eager module. The callers run the
    module under `torch.inference_mode`."""
    import vjepa2_tpu_torch.ops  # noqa: F401

    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(torch.export.load(path), device).module()


def _load_device(device) -> torch.device:
    from vjepa2_tpu_torch.core.device import entry_device

    return entry_device("cuda" if device is None else device)


def program_op_counts(program: torch.nn.Module) -> dict[str, int]:
    """The nodes of each ``vjepa2`` op in a loaded program, by op name, a
    loop body's counted once: one ``flash_fwd_dn`` a block of an encoder on
    the DN route."""
    return dict(collections.Counter(
        node.target.name().removeprefix("vjepa2::")
        for module in program.modules() if isinstance(module, torch.fx.GraphModule)
        for node in module.graph.nodes
        if node.op == "call_function" and isinstance(node.target, torch._ops.OpOverload)
        and node.target.namespace == "vjepa2"))


def export_encoder(encoder, out_dir: str, batch="B", dtype: Optional[str] = None) -> str:
    """Save the encoder's forward as a serving program.

    encoder: a `VisionTransformer` (its weights ride in the program); batch:
    an int for a fixed batch or a string (e.g. "B") for a symbolic batch
    dimension; dtype: the clips' dtype (a name or a torch dtype, fp32 by
    default). Traced on the device that holds the encoder. Returns out_dir.
    """
    T = encoder.num_frames
    H, W = encoder.img_size
    in_dtype = getattr(torch, dtype) if isinstance(dtype, str) else (dtype or torch.float32)
    dev = next(encoder.parameters()).device
    symbolic = isinstance(batch, str)
    clips = torch.zeros((2 if symbolic else int(batch), T, H, W, 3), dtype=in_dtype, device=dev)
    dynamic = ({0: torch.export.Dim(batch, min=1)},) if symbolic else None
    program = _export(encoder, (clips,), dynamic)
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, ENCODE_PROGRAM))
    _write_meta(out_dir, {
        "num_frames": int(T), "img_size": [int(H), int(W)],
        "in_dtype": str(in_dtype).removeprefix("torch."), "batch": batch,
        "embed_dim": int(encoder.embed_dim),
        "torch_version": torch.__version__,
    })
    return out_dir


def load_encoder(out_dir: str, device=None):
    """Load an exported encoder onto ``device`` (the card by default);
    returns (callable, meta). The callable takes clips [B, T, H, W, 3]
    (a tensor or an array, cast to the exported dtype) and returns features
    [B, N, D] on ``device``. No model module is imported on this path."""
    meta = _read_meta(out_dir)
    dev = _load_device(device)
    module = _load_program(os.path.join(out_dir, ENCODE_PROGRAM), dev)
    in_dtype = getattr(torch, meta["in_dtype"])

    def fn(clips):
        clips = torch.as_tensor(clips).to(device=dev, dtype=in_dtype)
        with torch.inference_mode():
            return module(clips)

    fn.module = module
    return fn, meta


def export_world_model(wm, out_dir: str) -> str:
    """Save a `planning.WorldModel` as two serving programs, the robot
    control loop's (reference hot loop `notebooks/utils/mpc_utils.py:28-163`):

    * ``encode``: frame [H, W, 3] fp32 -> latent tokens [N, D]
      (`WorldModel.encode_frame`);
    * ``plan``:   (rep [N, D], pose [7], goal [N, D],
                  noise [cem_steps, rollout, samples, 4]) -> actions
                  [rollout, 7] (`planning.cem.make_cem_from_noise` over
                  `WorldModel.step_fn`).

    The plan's CEM steps are one ``while_loop`` (JAX's ``lax.fori_loop``),
    its rollout frames unrolled, as in JAX: unrolled, the
    steps would put cem_steps x rollout x depth attention blocks (480 for
    the AC predictor at `CEMConfig()`) into the graph, whose export, save and
    load take seconds per block.

    The encoder's and the predictor's weights ride in their programs, traced
    on the device that holds them; `load_world_model` needs no model code.
    """
    from vjepa2_tpu_torch.hub.preprocessor import Preprocessor
    from vjepa2_tpu_torch.planning.cem import make_cem_from_noise

    enc = wm.encoder
    H, W = enc.img_size
    N, D = wm.tokens_per_frame, enc.embed_dim
    cfg = wm.cem_config
    # The host-side frame preprocessor (numpy resize/crop/normalize) cannot
    # ride the program (data-dependent input shapes); record it in meta so
    # ServingWorldModel.encode re-applies it, and refuse arbitrary callables
    # we cannot reconstruct on the load side.
    if wm.preprocessor is None:
        pp_meta = None
    elif isinstance(wm.preprocessor, Preprocessor):
        pp_meta = {"kind": "vjepa2", "crop_size": int(wm.preprocessor.crop_size)}
    else:
        raise ValueError(
            "export_world_model can only serialize the standard hub "
            "Preprocessor (or None); preprocess frames host-side and build "
            "the WorldModel with preprocessor=None instead")
    dev = wm.device
    f32 = dict(dtype=torch.float32, device=dev)
    encode = _export(_Program(wm.encode_frame, enc), (torch.zeros((H, W, 3), **f32),))
    noise = torch.zeros((cfg.cem_steps, cfg.rollout, cfg.samples, 4), **f32)
    plan_fn = make_cem_from_noise(wm.step_fn, cfg, loop_steps=True)
    plan = _export(_Program(plan_fn, wm.predictor),
                   (torch.zeros((N, D), **f32), torch.zeros(7, **f32), torch.zeros((N, D), **f32),
                    noise))
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(encode, os.path.join(out_dir, ENCODE_PROGRAM))
    torch.export.save(plan, os.path.join(out_dir, PLAN_PROGRAM))
    _write_meta(out_dir, {
        "img_size": [int(H), int(W)], "tokens_per_frame": int(N),
        "embed_dim": int(D), "normalize_reps": bool(wm.normalize_reps),
        "preprocessor": export_preprocessor_stats(),
        "frame_preprocessor": pp_meta,
        "cem": {k: getattr(cfg, k) for k in cfg.__dataclass_fields__},
        "torch_version": torch.__version__,
    })
    return out_dir


class ServingWorldModel:
    """A loaded world model: `encode(frame)` and `plan(rep, pose, goal)`.

    No model modules or tracing: the two programs with their weights, and
    (when the source WorldModel had one) the numpy frame preprocessor rebuilt
    from meta.json."""

    def __init__(self, out_dir: str, device=None):
        from vjepa2_tpu_torch.planning.cem import CEMConfig

        self.meta = _read_meta(out_dir)
        self.device = _load_device(device)
        self.cem_config = CEMConfig(**self.meta["cem"])
        pp = self.meta.get("frame_preprocessor")
        self._preproc = None
        if pp is not None:
            from vjepa2_tpu_torch.hub.preprocessor import vjepa2_preprocessor

            self._preproc = vjepa2_preprocessor(crop_size=pp["crop_size"])
        self._encode = _load_program(os.path.join(out_dir, ENCODE_PROGRAM), self.device)
        self._plan = _load_program(os.path.join(out_dir, PLAN_PROGRAM), self.device)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(device=self.device, dtype=torch.float32)

    def encode(self, frame) -> torch.Tensor:
        """frame [H, W, 3] uint8 (or preprocessed float) -> [N, D] tokens on
        the device, as `WorldModel.encode`."""
        if self._preproc is not None:
            # mirror WorldModel.encode: preprocess the single frame as a
            # length-1 clip (resize/crop/normalize on host)
            frame = self._preproc(np.asarray(frame)[None])[0]
        with torch.inference_mode():
            return self._encode(self._tensor(frame))

    def plan_from_noise(self, rep, pose, goal, noise) -> np.ndarray:
        """The plan [rollout, 7] on given draws [cem_steps, rollout, samples, 4]."""
        with torch.inference_mode():
            out = self._plan(*(self._tensor(x) for x in (rep, pose, goal, noise)))
        return out.cpu().numpy()

    def plan(self, rep, pose, goal, seed: int = 0) -> np.ndarray:
        """rep and goal [N, D]; pose [7] -> the planned actions [rollout, 7].
        The noise is drawn on the device from
        ``torch.Generator(device).manual_seed(seed)`` in the CEM's order
        (`planning.cem.cem_noise`), so the plan equals
        `WorldModel.infer_next_action` with that generator."""
        from vjepa2_tpu_torch.planning.cem import cem_noise

        gen = torch.Generator(self.device).manual_seed(int(seed))
        return self.plan_from_noise(rep, pose, goal, cem_noise(self.cem_config, self.device, gen))


def load_world_model(out_dir: str, device=None) -> ServingWorldModel:
    return ServingWorldModel(out_dir, device)


def export_preprocessor_stats() -> dict:
    """Serving-side normalization constants (match `hub/preprocessor.py`)."""
    from vjepa2_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

    return {"mean": np.asarray(IMAGENET_MEAN).tolist(),
            "std": np.asarray(IMAGENET_STD).tolist()}
