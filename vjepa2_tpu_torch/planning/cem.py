"""CEM / MPC over the latent world model (counterpart of
`vjepa2_tpu/planning/cem.py:42 make_cem`; reference
`notebooks/utils/mpc_utils.py:28-163`).

Each CEM step samples ``samples`` action trajectories ~ N(mean, std), rolls
the world model out ``rollout`` frames on all of them at once (one
predictor call a frame over the whole batch, as JAX batches them), ranks
the candidates by the L1 distance of their final latent to the goal and
moves (mean, std) towards the top-k with momentum. JAX's ``lax.fori_loop``
is a Python loop under `torch.inference_mode`; the rollout loop is unrolled
as in JAX. Nothing in the loop waits for the card: the plan is read back
once, by the caller.

The noise: ``jax.random.normal`` cannot be reproduced in torch, so each
(CEM step, rollout frame) draws [samples, 4] standard normals from an
explicit `torch.Generator` on the plan's device (seeded 0 when none is
given, as JAX's ``PRNGKey(0)`` default; never the global RNG). A
``sampler(step, h) -> [samples, 4]`` replaces that draw, which is how a test
feeds JAX's own draws. `cem_noise` makes every draw of a plan first, in
that order, into one tensor [cem_steps, rollout, samples, 4]; the plan
itself (`make_cem_from_noise`) is then a function of its tensors that draws
nothing and enters no inference mode, which `torch.export` traces into a
serving program (`hub.export.export_world_model`).

The ranking: ``lax.top_k(-dists, k)`` puts the lower index first among
equal distances; `torch.topk` promises no order for ties, so the port takes
the first k of a stable ascending sort, which keeps JAX's order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from vjepa2_tpu_torch.planning.rotations import compose_pose

Sampler = Callable[[int, int], torch.Tensor]


@dataclass(frozen=True)
class CEMConfig:
    rollout: int = 2
    cem_steps: int = 10
    samples: int = 400
    topk: int = 10
    momentum_mean: float = 0.15
    momentum_std: float = 0.15
    momentum_mean_gripper: float = 0.15
    momentum_std_gripper: float = 0.15
    maxnorm: float = 0.05


def _expand_action(a4: torch.Tensor) -> torch.Tensor:
    """[S, 4] (xyz + gripper) -> [S, 7] with zero rotation deltas."""
    zeros = a4.new_zeros((a4.shape[0], 3))
    return torch.cat([a4[:, :3], zeros, a4[:, 3:]], dim=-1)


def cem_noise(cfg: CEMConfig, device, generator: Optional[torch.Generator] = None,
              sampler: Optional[Sampler] = None) -> torch.Tensor:
    """Every draw of one plan, [cem_steps, rollout, samples, 4] fp32 on
    ``device``: ``sampler(step, h)``, or [samples, 4] standard normals from
    ``generator`` (one seeded 0 when None), drawn per (step, frame) in the
    CEM's order. One draw of the whole tensor would give other numbers on
    CUDA, whose generator advances its offset per call."""
    if sampler is None:
        gen = generator if generator is not None else torch.Generator(device).manual_seed(0)

        def sampler(step, h):
            return torch.randn((cfg.samples, 4), generator=gen, device=device)

    return torch.stack([torch.stack([sampler(step, h).to(device=device, dtype=torch.float32)
                                     for h in range(cfg.rollout)])
                        for step in range(cfg.cem_steps)])


def make_cem_from_noise(step_fn: Callable, cfg: CEMConfig, loop_steps: bool = False):
    """step_fn as `make_cem`'s. Returns ``plan(rep [N, D], pose [7] fp32,
    goal [N, D], noise [cem_steps, rollout, samples, 4]) -> [rollout, 7]``
    fp32: the CEM on the given draws, a function of its tensors alone.

    The CEM's steps run as a Python loop, or with ``loop_steps`` as one
    ``while_loop`` over a step counter (`torch._higher_order_ops.while_loop`,
    JAX's ``lax.fori_loop``): the same step on the same tensors, which an
    exported program then holds once where the Python loop would unroll it
    ``cem_steps`` times (`hub.export.export_world_model`). The rollout frames
    unroll either way, as in JAX: each frame's sequence is longer than the
    last's. (``scan`` would do as well, but torch 2.11's eager scan runs its
    body once more on the first draws to learn the output shapes.)"""

    def rollout_trajs(mean, std, noise, rep, pose):
        S = cfg.samples
        frame_seq = rep[None].expand(S, *rep.shape)  # [S, N, D]
        poses = pose[None, None].expand(S, 1, 7)
        actions = mean.new_zeros((S, 0, 7))
        for h in range(cfg.rollout):
            a4 = noise[h] * std[h] + mean[h]
            a4 = torch.cat([a4[:, :3].clamp(-cfg.maxnorm, cfg.maxnorm),
                            a4[:, 3:].clamp(-0.75, 0.75)], dim=-1)
            actions = torch.cat([actions, _expand_action(a4)[:, None]], dim=1)
            next_rep = step_fn(frame_seq, actions, poses)  # [S, N, D]
            frame_seq = torch.cat([frame_seq, next_rep], dim=1)
            next_pose = compose_pose(poses[:, -1], actions[:, -1])[:, None]
            poses = torch.cat([poses, next_pose], dim=1)
        return actions, frame_seq[:, -rep.shape[0]:]

    def cem_step(mean, std, noise, rep, pose, goal):
        """One CEM step on its draws [rollout, samples, 4]: the new (mean, std)."""
        actions, final = rollout_trajs(mean, std, noise, rep, pose)
        dists = (final.float() - goal[None]).abs().mean(dim=(1, 2))  # [S]
        idx = torch.sort(dists, stable=True).indices[:cfg.topk]
        sel = actions[idx]  # [k, rollout, 7]
        sel4 = torch.cat([sel[..., :3], sel[..., 6:7]], dim=-1)
        m_sel = sel4.mean(dim=0)
        s_sel = sel4.std(dim=0, correction=1)
        mean = torch.cat(
            [m_sel[..., :3] * (1 - cfg.momentum_mean) + mean[..., :3] * cfg.momentum_mean,
             m_sel[..., 3:] * (1 - cfg.momentum_mean_gripper)
             + mean[..., 3:] * cfg.momentum_mean_gripper], dim=-1)
        std = torch.cat(
            [s_sel[..., :3] * (1 - cfg.momentum_std) + std[..., :3] * cfg.momentum_std,
             s_sel[..., 3:] * (1 - cfg.momentum_std_gripper)
             + std[..., 3:] * cfg.momentum_std_gripper], dim=-1)
        return mean, std

    def plan(rep: torch.Tensor, pose: torch.Tensor, goal: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
        dev = rep.device
        goal = goal.float()
        mean = torch.zeros((cfg.rollout, 4), device=dev)
        std = torch.cat([torch.full((cfg.rollout, 3), cfg.maxnorm, device=dev),
                         torch.ones((cfg.rollout, 1), device=dev)], dim=-1)
        if loop_steps:
            from torch._higher_order_ops.while_loop import while_loop

            def more(step, mean, std):
                return step < cfg.cem_steps

            def body(step, mean, std):
                step_noise = noise.index_select(0, step.reshape(1))[0]
                return (step + 1, *cem_step(mean, std, step_noise, rep, pose, goal))

            first = torch.zeros((), dtype=torch.int64, device=dev)
            _, mean, std = while_loop(more, body, (first, mean, std))
        else:
            for step in range(cfg.cem_steps):
                mean, std = cem_step(mean, std, noise[step], rep, pose, goal)
        grip = torch.where(mean[..., 3:].abs() < 0.25, 0.0, mean[..., 3:])
        return torch.cat([mean[..., :3], mean.new_zeros((cfg.rollout, 3)), grip], dim=-1)

    return plan


def make_cem(step_fn: Callable, cfg: CEMConfig):
    """step_fn(reps [S, T*N, D], actions [S, T, 7], poses [S, T, 7]) -> the
    next frame's reps [S, N, D]. Returns
    ``cem(rep [N, D], pose [7], goal [N, D], generator=None, sampler=None)
    -> [rollout, 7]`` fp32, on ``rep``'s device: `cem_noise`'s draws, then
    `make_cem_from_noise`'s plan under `torch.inference_mode`."""
    plan = make_cem_from_noise(step_fn, cfg)

    def cem(rep: torch.Tensor, pose, goal: torch.Tensor,
            generator: Optional[torch.Generator] = None,
            sampler: Optional[Sampler] = None) -> torch.Tensor:
        dev = rep.device
        noise = cem_noise(cfg, dev, generator, sampler)
        with torch.inference_mode():
            pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
            return plan(rep, pose, goal, noise)

    return cem
