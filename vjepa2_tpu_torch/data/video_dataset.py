"""Map-style video dataset (counterpart of `vjepa2_tpu/data/video_dataset.py`;
reference `src/datasets/video_dataset.py`).

Manifests: CSV files of ``path label`` rows, space-delimited (a quoted path
may hold spaces), or ``::``-delimited where paths hold spaces; ``.npy``
arrays of paths (label 0). Frames per clip by dataset, the frame step from
``fps``, ``duration`` or ``frame_step``, clips sampled from one window or
spread over ``num_clips`` windows (evals), still images as clips of one
repeated frame (PIL), and on a decode failure a retry at a random index.

The CSV parse uses the standard `csv` module where JAX uses pandas (the
card's host has none). It gives JAX's samples and labels wherever JAX's parse
makes sense; where every row has ``::`` it takes that delimiter, where JAX's
``pd.read_csv(delimiter=" ")`` either raises (no row holds a space) or
splits the paths at their spaces (every row holds as many): ROADMAP queue C.

Runs on the loader's host workers and returns numpy; the loader collates and
the trainer copies to the card. A subclass may read another kind of file by
overriding `open_video`, the one place a reader is opened.
"""

from __future__ import annotations

import csv
import logging
import math
import os
from typing import Optional, Sequence

import numpy as np

from vjepa2_tpu_torch.data.video import VideoReadError, VideoReader

logger = logging.getLogger(__name__)

_IMAGE_EXTS = ("jpg", "jpeg", "png")


class ConcatIndices:
    """Global index -> (dataset_idx, local_idx) (reference `dataloader.py:19-37`)."""

    def __init__(self, sizes: Sequence[int]):
        self.cumsum = np.cumsum([0] + list(sizes))

    def __getitem__(self, idx: int) -> tuple[int, int]:
        d = int(np.searchsorted(self.cumsum, idx, side="right") - 1)
        return d, int(idx - self.cumsum[d])

    @property
    def total(self) -> int:
        return int(self.cumsum[-1])


def _typed_column(values: list[str]) -> list:
    """A column as pandas infers it: ints if every entry parses as one,
    else floats if every entry does, else the strings."""
    for cast in (int, float):
        try:
            return [cast(v) for v in values]
        except ValueError:
            pass
    return values


def read_csv_manifest(path: str) -> tuple[list[str], list]:
    """(samples, labels) of a ``path label`` manifest: ``::``-delimited
    where every row holds ``::``, else space-delimited with csv quoting.
    Blank rows are skipped; a row without a label raises."""
    with open(path, newline="") as f:
        lines = [ln.rstrip("\r\n") for ln in f]
    lines = [ln for ln in lines if ln.strip()]
    if lines and all("::" in ln for ln in lines):
        rows = [ln.split("::") for ln in lines]
    else:
        rows = list(csv.reader(lines, delimiter=" ", quotechar='"'))
    for i, row in enumerate(rows):
        if len(row) < 2:
            raise ValueError(f"{path}: row {i + 1} {row!r} has no label (want 'path label', "
                             "space- or '::'-delimited)")
    return [r[0] for r in rows], _typed_column([r[1] for r in rows])


class VideoDataset:
    def __init__(
        self,
        data_paths: Sequence[str],
        datasets_weights: Optional[Sequence[float]] = None,
        frames_per_clip: int = 16,
        dataset_fpcs: Optional[Sequence[int]] = None,
        fps: Optional[int] = None,
        frame_step: Optional[int] = 4,
        duration: Optional[float] = None,
        num_clips: int = 1,
        transform=None,
        shared_transform=None,
        random_clip_sampling: bool = True,
        allow_clip_overlap: bool = False,
        filter_short_videos: bool = False,
        filter_long_videos: int = int(1e9),
        seed: int = 0,
    ):
        if sum(v is not None for v in (fps, duration, frame_step)) != 1:
            raise ValueError("specify exactly one of fps, duration, frame_step")
        if isinstance(data_paths, str):
            data_paths = [data_paths]
        self.data_paths = list(data_paths)
        self.fps = fps
        self.frame_step = frame_step
        self.duration = duration
        self.num_clips = num_clips
        self.transform = transform
        self.shared_transform = shared_transform
        self.random_clip_sampling = random_clip_sampling
        self.allow_clip_overlap = allow_clip_overlap
        self.filter_short_videos = filter_short_videos
        self.filter_long_videos = filter_long_videos
        self.seed = seed
        self.rng = np.random.default_rng(seed)

        self.dataset_fpcs = (list(dataset_fpcs) if dataset_fpcs is not None
                             else [frames_per_clip] * len(self.data_paths))
        if len(self.dataset_fpcs) != len(self.data_paths):
            raise ValueError("dataset_fpcs must match data_paths")

        samples, labels, sizes = [], [], []
        for path in self.data_paths:
            if path.endswith(".csv"):
                s, lab = read_csv_manifest(path)
            elif path.endswith(".npy"):
                s = [str(x) for x in np.load(path, allow_pickle=True)]
                lab = [0] * len(s)
            else:
                raise ValueError(f"unsupported manifest {path}")
            samples += s
            labels += lab
            sizes.append(len(s))
        self.samples = samples
        self.labels = labels
        self.num_samples_per_dataset = sizes
        self.per_dataset_indices = ConcatIndices(sizes)

        self.sample_weights = None
        if datasets_weights is not None:
            w = []
            for dw, ns in zip(datasets_weights, sizes):
                w += [dw / ns] * ns
            self.sample_weights = np.asarray(w)

    def __len__(self) -> int:
        return len(self.samples)

    def set_epoch(self, epoch: int) -> None:
        """Draw epoch ``epoch``'s windows and crops: the stream of ``seed`` at
        epoch 0 (JAX's, which every epoch replays), another an epoch after."""
        self.rng = np.random.default_rng(self.seed if epoch == 0 else [self.seed, epoch])

    def fpc_for_index(self, index: int) -> int:
        d, _ = self.per_dataset_indices[index]
        return self.dataset_fpcs[d]

    def __getitem__(self, index: int):
        for _ in range(100):
            sample = self.samples[index]
            try:
                if str(sample).split(".")[-1].lower() in _IMAGE_EXTS:
                    out = self._get_image(index)
                else:
                    out = self._get_video(index)
                if out is not None:
                    return out
            except (VideoReadError, OSError) as e:
                logger.warning("decode failure for %s: %s", sample, e)
            index = int(self.rng.integers(0, len(self)))
        raise RuntimeError("too many consecutive decode failures")

    # -- video --------------------------------------------------------------
    def open_video(self, path: str):
        """The reader of one video: ``len``, ``avg_fps`` and
        ``get_batch(indices)`` -> uint8 [T, H, W, 3]."""
        return VideoReader(path)

    def _get_video(self, index: int):
        sample = self.samples[index]
        fpc = self.fpc_for_index(index)
        buffer, clip_indices = self._load_video(sample, fpc)
        if buffer is None or len(buffer) == 0:
            return None
        if self.shared_transform is not None:
            buffer = self.shared_transform(buffer)
        clips = [buffer[i * fpc:(i + 1) * fpc] for i in range(self.num_clips)]
        if self.transform is not None:
            clips = [self.transform(c, rng=self.rng) for c in clips]
        return clips, self.labels[index], clip_indices

    def _load_video(self, path: str, fpc: int):
        if os.path.exists(path) and os.path.getsize(path) > self.filter_long_videos:
            return None, None
        vr = self.open_video(path)
        # the step between a clip's frames: from the video's fps where the
        # clip spans ``duration`` seconds or samples ``fps`` frames a second
        fstp = self.frame_step
        if self.duration is not None:
            fstp = max(1, int(self.duration * math.ceil(vr.avg_fps) / fpc))
        elif self.fps is not None:
            fstp = max(1, int(math.ceil(vr.avg_fps)) // self.fps)
        clip_len = int(fpc * fstp)
        if self.filter_short_videos and len(vr) < clip_len:
            return None, None

        partition_len = len(vr) // self.num_clips
        all_indices, clip_indices = [], []
        for i in range(self.num_clips):
            if partition_len > clip_len:
                # a random window of the partition (its first without random sampling)
                end_indx = clip_len
                if self.random_clip_sampling:
                    end_indx = int(self.rng.integers(clip_len, partition_len))
                start_indx = end_indx - clip_len
                indices = np.linspace(start_indx, end_indx, num=fpc)
                indices = np.clip(indices, start_indx, end_indx - 1).astype(np.int64)
                indices = indices + i * partition_len
            elif not self.allow_clip_overlap:
                # the partition is short: every fstp-th frame, then its last repeated
                npts = max(1, partition_len // fstp)
                indices = np.linspace(0, partition_len, num=npts)
                indices = np.concatenate((indices, np.ones(fpc - npts) * partition_len))
                indices = np.clip(indices, 0, partition_len - 1).astype(np.int64)
                indices = indices + i * partition_len
            else:
                # overlapping clips spread evenly over the whole video
                sample_len = min(clip_len, len(vr)) - 1
                npts = max(1, sample_len // fstp)
                indices = np.linspace(0, sample_len, num=npts)
                indices = np.concatenate((indices, np.ones(fpc - npts) * sample_len))
                indices = np.clip(indices, 0, sample_len - 1).astype(np.int64)
                clip_step = 0
                if len(vr) > clip_len and self.num_clips > 1:
                    clip_step = (len(vr) - clip_len) // (self.num_clips - 1)
                indices = indices + i * clip_step
            clip_indices.append(indices)
            all_indices.extend(list(indices))
        return vr.get_batch(all_indices), clip_indices

    # -- still images -------------------------------------------------------
    def _get_image(self, index: int):
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError("image entries of a video manifest need the PIL package") from e

        fpc = self.fpc_for_index(index)
        img = np.asarray(Image.open(self.samples[index]).convert("RGB"))
        buffer = np.repeat(img[None], fpc, axis=0)
        clip_indices = [np.arange(fpc, dtype=np.int32)]
        if self.shared_transform is not None:
            buffer = self.shared_transform(buffer)
        clips = [buffer]
        if self.transform is not None:
            clips = [self.transform(buffer, rng=self.rng)]
        return clips, self.labels[index], clip_indices
