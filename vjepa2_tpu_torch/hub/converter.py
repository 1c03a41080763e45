"""JAX parameter tree -> the port's state dict (inverse of
`vjepa2_tpu/hub/converter.py:73 convert_encoder`, `:95 convert_predictor`
and `:133 convert_attentive_classifier`).

The port keeps the reference's torch state-dict names, so released torch
checkpoints load into it directly; this converter is how weights cross from
the JAX package (nested dicts of arrays) into the port, for example in the
parity tests. Layout rules, the JAX converter's read backwards:

* ``<name>_<i>`` scopes       -> ``<name>.<i>`` (``blocks_3`` -> ``blocks.3``)
* Dense ``kernel`` [in, out]  -> ``weight`` [out, in]
* conv ``kernel`` [t, p, p, C, D] -> ``weight`` [D, C, t, p, p]
* LayerNorm ``scale``         -> ``weight``
* the predictor's ``mask_tokens`` [num, P] -> ``mask_tokens.{j}`` [1, 1, P]
  (`vjepa2_tpu/hub/converter.py:104-107,246-249`)
* anything else keeps its name (``bias``, ``query_tokens``)

The AC predictor's tree (the inverse of `vjepa2_tpu/hub/converter.py:117
convert_ac_predictor`: ``predictor_embed``, ``action_encoder``,
``state_encoder``, ``extrinsics_encoder``, ``predictor_blocks_<i>``,
``predictor_norm``, ``predictor_proj``) takes the same rules.

A frozen eval's probe grid (JAX's `evals/probes.py:ProbeGrid`, the grid of
`evals/action_anticipation.py:AnticipationEval`) stacks every probe leaf on
a leading [P] axis: `probe_grid_from_flax` turns it into the port's grid
params (each state-dict name -> its [P, ...] stack), for the
`AttentiveClassifier` and the `MultiHeadAttentiveClassifier` trees alike,
and `adam_state_from_optax` turns the stacked optax ``ScaleByAdamState``
(count, mu, nu) into the port's grid optimizer state.

`load_pretrain_state` carries a whole pretrain state across: JAX's
``params = {"encoder", "predictor"}`` and ``target_params`` into a port
`TrainState`, so that JAX and the port can start from one set of weights;
`load_droid_state` does the same for the AC post-training state, and
`load_world_model_state` for a planning `WorldModel`'s encoder and predictor.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch


def _leaf(name: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 5:
            return "weight", arr.transpose(4, 3, 0, 1, 2)
        raise ValueError(f"unexpected kernel rank {arr.ndim}")
    if name == "scale":
        return "weight", arr
    return name, arr


def state_dict_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax params (optionally under a top-level ``"params"``) -> fp32 torch
    state dict with the reference's key names."""
    if set(params) == {"params"}:
        params = params["params"]
    sd: dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for name, val in node.items():
            if isinstance(val, Mapping):
                m = re.fullmatch(r"(.+)_(\d+)", name)
                walk(val, prefix + (f"{m.group(1)}.{m.group(2)}" if m else name) + ".")
            elif name == "mask_tokens":
                for j, row in enumerate(np.array(val, dtype=np.float32)):
                    sd[f"{prefix}mask_tokens.{j}"] = torch.from_numpy(row.reshape(1, 1, -1))
            else:
                key, arr = _leaf(name, np.array(val, dtype=np.float32))
                sd[prefix + key] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(params, "")
    return sd


def load_pretrain_state(state, params: Mapping[str, Any], target_params: Mapping[str, Any]):
    """Load JAX's pretrain parameter trees (``params["encoder"]``,
    ``params["predictor"]`` and the EMA ``target_params``) into the port's
    `TrainState` ``state``, in place, onto its models' devices; the
    optimizer's moments are left as they are. Returns ``state``."""
    state.encoder.load_state_dict(state_dict_from_flax(params["encoder"]))
    state.predictor.load_state_dict(state_dict_from_flax(params["predictor"]))
    state.target_encoder.load_state_dict(state_dict_from_flax(target_params))
    return state


def load_droid_state(state, params: Mapping[str, Any], target_params: Mapping[str, Any]):
    """Load JAX's AC post-training trees (``params["predictor"]`` and the
    frozen ``target_params``) into the port's `DroidState` ``state``, in
    place; the optimizer's moments are left as they are. JAX's
    ``params["encoder"]``, the copy it carries with ``enc_lr_scale > 0``,
    has no counterpart in the port (its gradient is zero and it never
    changes, `train/droid.py`). Returns ``state``."""
    state.predictor.load_state_dict(state_dict_from_flax(params["predictor"]))
    state.target_encoder.load_state_dict(state_dict_from_flax(target_params))
    return state


def load_world_model_state(wm, enc_params: Mapping[str, Any], pred_params: Mapping[str, Any]):
    """Load JAX's `WorldModel` trees (its ``enc_params`` and ``pred_params``,
    `vjepa2_tpu/planning/world_model.py:22`) into the port's `WorldModel`
    ``wm``, in place, onto its modules' devices. Returns ``wm``."""
    wm.encoder.load_state_dict(state_dict_from_flax(enc_params))
    wm.predictor.load_state_dict(state_dict_from_flax(pred_params))
    return wm


def _probe_slice(node: Mapping[str, Any], i: int) -> dict:
    return {name: _probe_slice(val, i) if isinstance(val, Mapping) else np.asarray(val)[i]
            for name, val in node.items()}


def probe_grid_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX's [P]-stacked probe params (optionally under ``"params"``) ->
    {state-dict name: fp32 [P, ...] tensor}: each probe through
    `state_dict_from_flax`, then stacked."""
    if set(params) == {"params"}:
        params = params["params"]
    leaf = params
    while isinstance(leaf, Mapping):
        leaf = next(iter(leaf.values()))
    per_probe = [state_dict_from_flax(_probe_slice(params, i))
                 for i in range(np.asarray(leaf).shape[0])]
    return {k: torch.stack([sd[k] for sd in per_probe]) for k in per_probe[0]}


def adam_state_from_optax(opt) -> dict:
    """JAX's stacked optax ``ScaleByAdamState`` (``count`` [P], ``mu`` and
    ``nu`` trees shaped as the params) -> the port's grid optimizer state
    {"mu", "nu", "count" (int32 [P])}."""
    return {"mu": probe_grid_from_flax(opt.mu), "nu": probe_grid_from_flax(opt.nu),
            "count": torch.from_numpy(np.asarray(opt.count, dtype=np.int32).copy())}
