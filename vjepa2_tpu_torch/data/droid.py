"""DROID robot trajectories (counterpart of `vjepa2_tpu/data/droid.py`;
reference `app/vjepa_droid/droid.py`).

A trajectory is a directory holding ``trajectory.h5`` (robot state and
camera extrinsics), a metadata ``.json`` naming each camera's recording, and
the recordings under ``recordings/MP4/``. A sample is a random window,
resampled to ``fps``, of one randomly chosen camera view: (clip [T, H, W, C],
actions [T-1, 7], states [T, 7], extrinsics [T, 6], frame indices). Actions
are pose deltas with relative angles through rotation matrices; with
``camera_frame`` the poses are first taken through the inverse extrinsics.

The manifest is a space-delimited CSV whose first column lists the
trajectory directories, read with the `csv` module where JAX uses pandas.
The metadata ``.json`` is the first of the directory's in sorted order: JAX
takes the first in `os.listdir` order, which depends on the file system (the
same file wherever a directory holds one; ROADMAP queue C).

`read_trajectory` and `open_video` are the two places a file is opened; a
subclass may read other files by overriding them. The default reader needs
h5py, and the dataset raises `ImportError` without it, as JAX's does.
Runs on the loader's host workers and returns numpy.
"""

from __future__ import annotations

import csv
import json
import logging
import math
import os
from typing import Optional, Sequence

import numpy as np

from vjepa2_tpu_torch.data.video import VideoReader

logger = logging.getLogger(__name__)

MAX_RETRIES = 100  # consecutive failed loads before a sample raises (JAX's)


def _rotation():
    from scipy.spatial.transform import Rotation

    return Rotation


def poses_to_diffs(poses: np.ndarray) -> np.ndarray:
    """[T, 7] absolute poses (xyz, euler xyz, gripper) -> [T-1, 7] deltas;
    the angle deltas are those of R_{t+1} R_t^T (reference `droid.py:137-147`)."""
    rot = _rotation()
    mats = rot.from_euler("xyz", poses[:, 3:6], degrees=False).as_matrix()
    angle_diff = np.stack([rot.from_matrix(mats[t + 1] @ mats[t].T).as_euler("xyz", degrees=False)
                           for t in range(len(mats) - 1)])
    xyz, closed = poses[:, :3], poses[:, -1:]
    return np.concatenate([xyz[1:] - xyz[:-1], angle_diff, closed[1:] - closed[:-1]], axis=1)


def transform_to_camera_frame(poses: np.ndarray, extrinsics: np.ndarray) -> np.ndarray:
    """[T, 7] poses expressed in the camera frame: each pose's transform
    left-multiplied by the inverse of its [6] extrinsics' (reference
    `droid.py:149-176`); the gripper column unchanged."""
    rot = _rotation()

    def to_matrix(p):
        m = np.eye(4)
        m[:3, :3] = rot.from_euler("xyz", p[3:6], degrees=False).as_matrix()
        m[:3, 3] = p[:3]
        return m

    out = []
    for p, e in zip(poses[:, :-1], extrinsics):
        m = np.linalg.inv(to_matrix(e)) @ to_matrix(p)
        out.append(np.concatenate([m[:3, 3], rot.from_matrix(m[:3, :3]).as_euler(
            "xyz", degrees=False)]))
    return np.concatenate([np.stack(out), poses[:, -1:]], axis=1)


def read_trajectory_list(path: str) -> list[str]:
    """The first column of a space-delimited CSV without a header
    (`pd.read_csv(path, header=None, delimiter=" ")`'s); blank rows skipped."""
    with open(path, newline="") as f:
        lines = [ln.rstrip("\r\n") for ln in f if ln.strip()]
    return [row[0] for row in csv.reader(lines, delimiter=" ", quotechar='"')]


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("h5py required for DROID dataset: the trajectories' "
                          "trajectory.h5 files are HDF5") from e
    return h5py


class DROIDVideoDataset:
    # whether `read_trajectory` is the h5py reader (a subclass that reads
    # other files sets it False)
    needs_h5py = True

    def __init__(self, data_path: str,
                 camera_views: Sequence[str] = ("left_mp4_path", "right_mp4_path"),
                 frameskip: int = 2, frames_per_clip: int = 16, fps: Optional[int] = 5,
                 transform=None, camera_frame: bool = False, seed: int = 0):
        if self.needs_h5py:
            _h5py()
        self.camera_views = list(camera_views)
        self.frameskip = frameskip
        self.frames_per_clip = frames_per_clip
        self.fps = fps
        self.transform = transform
        self.camera_frame = camera_frame
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.samples = read_trajectory_list(data_path)

    def __len__(self) -> int:
        return len(self.samples)

    def set_epoch(self, epoch: int) -> None:
        """Draw epoch ``epoch``'s views, windows and crops: the stream of
        ``seed`` at epoch 0 (JAX's, which every epoch replays), another an
        epoch after."""
        self.rng = np.random.default_rng(self.seed if epoch == 0 else [self.seed, epoch])

    def __getitem__(self, index: int):
        for _ in range(MAX_RETRIES):
            path = self.samples[index]
            try:
                return self._load(path)
            except Exception as e:
                logger.info("failed to load droid trajectory %s: %s", path, e)
                index = int(self.rng.integers(0, len(self)))
        raise RuntimeError("too many consecutive DROID load failures")

    def _metadata(self, path: str) -> dict:
        for fname in sorted(os.listdir(path)):
            if fname.endswith(".json"):
                with open(os.path.join(path, fname)) as f:
                    return json.load(f)
        raise FileNotFoundError(f"no metadata json in {path}")

    def read_trajectory(self, path: str) -> dict:
        """The robot state and extrinsics of trajectory directory ``path``:
        {"cartesian_position": [T, 6], "gripper_position": [T],
        "camera_extrinsics": {name: [T, 6]}}, from its ``trajectory.h5``."""
        with _h5py().File(os.path.join(path, "trajectory.h5"), "r") as traj:
            obs = traj["observation"]
            state = obs["robot_state"]
            return {"cartesian_position": np.asarray(state["cartesian_position"]),
                    "gripper_position": np.asarray(state["gripper_position"]),
                    "camera_extrinsics": {k: np.asarray(v)
                                          for k, v in obs["camera_extrinsics"].items()}}

    def open_video(self, path: str):
        """The reader of one recording: ``len``, ``avg_fps`` and
        ``get_batch(indices)`` -> uint8 [T, H, W, 3]."""
        return VideoReader(path)

    def _load(self, path: str):
        meta = self._metadata(path)
        traj = self.read_trajectory(path)
        view = self.camera_views[int(self.rng.integers(0, len(self.camera_views)))]
        mp4_name = meta[view].split("recordings/MP4/")[-1]
        camera_name = mp4_name.split(".")[0]
        extr = traj["camera_extrinsics"][f"{camera_name}_left"]
        states = np.concatenate([traj["cartesian_position"],
                                 traj["gripper_position"][:, None]], axis=1)
        vr = self.open_video(os.path.join(path, "recordings/MP4", mp4_name))
        vfps = vr.avg_fps
        fpc = self.frames_per_clip
        fps = self.fps if self.fps is not None else vfps
        fstp = math.ceil(vfps / fps)
        nframes = int(fpc * fstp)
        if len(vr) < nframes:
            raise ValueError(f"video too short: {len(vr)} < {nframes}")

        ef = int(self.rng.integers(nframes, len(vr)))
        sf = ef - nframes
        indices = np.arange(sf, sf + nframes, fstp).astype(np.int64)

        states = states[indices][::self.frameskip]
        extr = extr[indices][::self.frameskip]
        if self.camera_frame:
            states = transform_to_camera_frame(states, extr)
        actions = poses_to_diffs(states)

        buffer = vr.get_batch(indices)
        if self.transform is not None:
            buffer = self.transform(buffer, rng=self.rng)
        return buffer, actions, states, extr, indices


def droid_collate(samples):
    """[(clip, actions, states, extrinsics, indices), ...] -> (clips,
    actions, states, extrinsics), stacked; the last three float32."""
    clips = np.stack([s[0] for s in samples])
    actions = np.stack([s[1] for s in samples]).astype(np.float32)
    states = np.stack([s[2] for s in samples]).astype(np.float32)
    extr = np.stack([s[3] for s in samples]).astype(np.float32)
    return clips, actions, states, extr
