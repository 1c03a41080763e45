"""Latent planning over the V-JEPA 2-AC world model (counterpart of
`vjepa2_tpu/planning`): CEM (`cem`), pose math (`rotations`) and the
`WorldModel` wrapper (`world_model`). `WorldModel` is imported on first use,
so that the CEM and the pose math load without the models (a serving process
draws a plan's noise with `cem_noise`, `hub.export.ServingWorldModel`)."""

from vjepa2_tpu_torch.planning.cem import CEMConfig, cem_noise, make_cem, make_cem_from_noise
from vjepa2_tpu_torch.planning.rotations import (
    compose_pose,
    euler_xyz_to_matrix,
    matrix_to_euler_xyz,
    pose_diff,
)

__all__ = [
    "CEMConfig",
    "make_cem",
    "make_cem_from_noise",
    "cem_noise",
    "compose_pose",
    "euler_xyz_to_matrix",
    "matrix_to_euler_xyz",
    "pose_diff",
    "WorldModel",
]


def __getattr__(name):
    if name == "WorldModel":
        from vjepa2_tpu_torch.planning.world_model import WorldModel

        return WorldModel
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
