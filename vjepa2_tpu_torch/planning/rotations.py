"""Rotation utilities for planning, extrinsic-xyz Euler angles
(counterpart of `vjepa2_tpu/planning/rotations.py`).

The convention is scipy's ``Rotation.from_euler("xyz", ...)`` (extrinsic):
R = Rz @ Ry @ Rx. Plain tensor functions, computed in the dtype they are
given (the CEM gives fp32), on whatever device holds the tensors, so pose
composition stays on the card inside the planning loop. `matrix_to_euler_xyz`
keeps JAX's unguarded formula (no gimbal-lock branch, unlike scipy's).
"""

from __future__ import annotations

import torch


def euler_xyz_to_matrix(euler: torch.Tensor) -> torch.Tensor:
    """euler [..., 3] (x, y, z angles, radians) -> [..., 3, 3]."""
    a, b, c = euler[..., 0], euler[..., 1], euler[..., 2]
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    # R = Rz(c) @ Ry(b) @ Rx(a)
    row0 = torch.stack([cc * cb, cc * sb * sa - sc * ca, cc * sb * ca + sc * sa], dim=-1)
    row1 = torch.stack([sc * cb, sc * sb * sa + cc * ca, sc * sb * ca - cc * sa], dim=-1)
    row2 = torch.stack([-sb, cb * sa, cb * ca], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_euler_xyz(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3] extrinsic-xyz angles (gimbal lock unguarded)."""
    b = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    a = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    c = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([a, b, c], dim=-1)


def compose_pose(pose: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """The end-effector pose after a delta action (reference
    `compute_new_pose`). pose, action: [..., 7] = (xyz, euler_xyz, gripper);
    new rotation = R(delta) @ R(pose); gripper clipped to [0, 1]."""
    new_xyz = pose[..., :3] + action[..., :3]
    R = euler_xyz_to_matrix(pose[..., 3:6])
    dR = euler_xyz_to_matrix(action[..., 3:6])
    new_angle = matrix_to_euler_xyz(dR @ R)
    new_grip = torch.clamp(pose[..., 6:7] + action[..., 6:7], 0.0, 1.0)
    return torch.cat([new_xyz, new_angle, new_grip], dim=-1)


def pose_diff(start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """The delta action taking ``start`` to ``end`` (reference
    `mpc_utils.py:poses_to_diff`): xyz and gripper differences and the
    relative rotation R(end) @ R(start)^T as extrinsic-xyz angles. The
    inverse of `compose_pose` up to the gripper clip."""
    xyz = end[..., :3] - start[..., :3]
    Rs = euler_xyz_to_matrix(start[..., 3:6])
    Re = euler_xyz_to_matrix(end[..., 3:6])
    theta = matrix_to_euler_xyz(Re @ Rs.transpose(-1, -2))
    grip = end[..., 6:7] - start[..., 6:7]
    return torch.cat([xyz, theta, grip], dim=-1)
