"""Latent planning over the V-JEPA 2-AC world model (counterpart of
`vjepa2_tpu/planning`): CEM (`cem`), pose math (`rotations`) and the
`WorldModel` wrapper (`world_model`)."""

from vjepa2_tpu_torch.planning.cem import CEMConfig, make_cem
from vjepa2_tpu_torch.planning.rotations import (
    compose_pose,
    euler_xyz_to_matrix,
    matrix_to_euler_xyz,
    pose_diff,
)
from vjepa2_tpu_torch.planning.world_model import WorldModel

__all__ = [
    "CEMConfig",
    "make_cem",
    "compose_pose",
    "euler_xyz_to_matrix",
    "matrix_to_euler_xyz",
    "pose_diff",
    "WorldModel",
]
