"""EPIC-Kitchens-100 action anticipation (counterpart of
`vjepa2_tpu/data/epickitchens.py`; reference
`evals/action_anticipation_frozen/epickitchens.py`).

An annotation CSV with a header row, one action a row::

  video_path,start_sec,stop_sec,verb,noun,action[,fps]

`EpicKitchensAnticipation` serves it map-style: for each row an
anticipation point and time drawn in the configured ranges, and the context
clip that ends that long before the anticipated moment (reference
`decode_videos_to_clips`, `epickitchens.py:81-153`). `EpicKitchensShardStream`
is the reference's webdataset pipeline: one shard a video, a seeded shard
order an epoch, split by node and by worker, partial batches.
`build_action_label_space` gives the verb, noun and action indices of the
training rows.

The CSV is read with the `csv` module where JAX uses pandas, and each
column typed as pandas types it (`video_dataset.typed_column`: ints where
every entry is one, else floats, else strings). The label spaces sort the
ids, so numeric ids must sort as numbers: EK100's class ids are integers,
and as strings "10" would sort before "2".
"""

from __future__ import annotations

import csv
import itertools
import logging
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from vjepa2_tpu_torch.data.video import VideoReadError, VideoReader
from vjepa2_tpu_torch.data.video_dataset import typed_column

logger = logging.getLogger(__name__)

REQUIRED_COLUMNS = {"video_path", "start_sec", "stop_sec", "verb", "noun"}


def read_annotations(path: str) -> tuple[list[str], list[dict]]:
    """(header, rows) of an annotation CSV (header first, blank rows
    skipped): each row a dict of the columns typed as `pd.read_csv` types
    them."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    header, body = rows[0], rows[1:]
    columns = [typed_column([r[i] for r in body]) for i in range(len(header))]
    return header, [dict(zip(header, values)) for values in zip(*columns)]


def build_action_label_space(rows: Sequence[dict]) -> dict:
    """Verb, noun and (verb, noun) action indices of the rows' sorted ids:
    the label spaces filtered to the training set's actions."""
    verbs = sorted({r["verb"] for r in rows})
    nouns = sorted({r["noun"] for r in rows})
    pairs = sorted({(r["verb"], r["noun"]) for r in rows})
    return {"verb_to_idx": {v: i for i, v in enumerate(verbs)},
            "noun_to_idx": {n: i for i, n in enumerate(nouns)},
            "action_to_idx": {p: i for i, p in enumerate(pairs)}}


@dataclass
class AnticipationSample:
    clip: np.ndarray  # [T, H, W, 3]
    anticipation_time: float  # seconds into the future
    verb: int
    noun: int
    action: int


class _LabelSpaces:
    """The label-space sizes of a dataset's ``label_space``."""

    @property
    def num_verbs(self) -> int:
        return len(self.label_space["verb_to_idx"])

    @property
    def num_nouns(self) -> int:
        return len(self.label_space["noun_to_idx"])

    @property
    def num_actions(self) -> int:
        return len(self.label_space["action_to_idx"])

    def valid_action_classes(self) -> set:
        return set(self.label_space["action_to_idx"].values())

    def _sample(self, clip, at: float, row: dict) -> AnticipationSample:
        """A sample of ``row``'s labels; an id missing from the label space is 0."""
        ls = self.label_space
        return AnticipationSample(clip, at, ls["verb_to_idx"].get(row["verb"], 0),
                                  ls["noun_to_idx"].get(row["noun"], 0),
                                  ls["action_to_idx"].get((row["verb"], row["noun"]), 0))


class EpicKitchensAnticipation(_LabelSpaces):
    def __init__(self, annotations_csv: str, label_space: Optional[dict] = None,
                 frames_per_clip: int = 16, frame_step: int = 4,
                 anticipation_time_range: tuple[float, float] = (1.0, 1.0),
                 anticipation_point_range: tuple[float, float] = (0.1, 0.1),
                 transform=None, seed: int = 0):
        header, self.rows = read_annotations(annotations_csv)
        missing = REQUIRED_COLUMNS - set(header)
        if missing:
            raise ValueError(f"annotation csv missing columns: {missing}")
        self.label_space = label_space or build_action_label_space(self.rows)
        self.fpc = frames_per_clip
        self.frame_step = frame_step
        self.at_range = anticipation_time_range
        self.ap_range = anticipation_point_range
        self.transform = transform
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, index: int) -> AnticipationSample:
        for _ in range(50):
            row = self.rows[index]
            try:
                return self._load(row)
            except (VideoReadError, OSError, ValueError) as e:
                logger.warning("anticipation sample failed (%s); resampling", e)
                index = int(self.rng.integers(0, len(self)))
        raise RuntimeError("too many anticipation decode failures")

    def open_video(self, path: str):
        """The reader of one video: ``len``, ``avg_fps`` and
        ``get_batch(indices)`` -> uint8 [T, H, W, 3]."""
        return VideoReader(path)

    def _load(self, row: dict) -> AnticipationSample:
        vr = self.open_video(str(row["video_path"]))
        fps = vr.avg_fps
        # the anticipation point: a fraction into the action segment, the
        # anticipated moment; the anticipation time: how long before it the
        # context clip ends
        ap = float(self.rng.uniform(*self.ap_range))
        at = float(self.rng.uniform(*self.at_range))
        start, stop = float(row["start_sec"]), float(row["stop_sec"])
        action_t = start + ap * (stop - start)
        end_frame = int(max(0.0, action_t - at) * fps)
        start_frame = max(0, end_frame - self.fpc * self.frame_step)
        indices = np.linspace(start_frame, max(start_frame + 1, end_frame - 1),
                              num=self.fpc).astype(np.int64)
        clip = vr.get_batch(indices)
        if self.transform is not None:
            clip = self.transform(clip, rng=self.rng)
        return self._sample(clip, at, row)


def anticipation_collate(samples: Sequence[AnticipationSample]):
    """Samples -> (clips [B, T, H, W, 3], anticipation times [B] float32,
    verbs [B], nouns [B], actions [B])."""
    clips = np.stack([s.clip for s in samples])
    at = np.asarray([s.anticipation_time for s in samples], np.float32)
    verbs = np.asarray([s.verb for s in samples])
    nouns = np.asarray([s.noun for s in samples])
    actions = np.asarray([s.action for s in samples])
    return clips, at, verbs, nouns, actions


# ---------------------------------------------------------------------------
# The stream (reference webdataset path, `epickitchens.py:156-216`): a shard
# a video; a seeded shard order an epoch -> node split -> worker split -> each
# annotation's clip -> partial batches.
# ---------------------------------------------------------------------------


class ResampledVideoShards:
    """The shard (video) paths in a permutation seeded by the epoch in
    training, in order otherwise (reference `ResampledShards`,
    `epickitchens.py:156-174`)."""

    def __init__(self, paths: Sequence[str], training: bool = True, epoch: int = 0):
        self.paths = list(paths)
        self.training = training
        self.epoch = epoch

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __iter__(self):
        if self.training:
            order = np.random.default_rng(self.epoch).permutation(len(self.paths))
            yield from (self.paths[i] for i in order)
        else:
            yield from self.paths


def split_by_node(shards, rank: int, world_size: int):
    """Every ``world_size``-th shard from ``rank`` (reference `split_by_node`,
    `:63-78`)."""
    if world_size > 1:
        return itertools.islice(shards, rank, None, world_size)
    return iter(shards)


class EpicKitchensShardStream(_LabelSpaces):
    """The anticipation batches of one node's and one worker's shards, from
    the map-style dataset's annotation CSV: each shard's annotations in
    their order, each clip the ``frames_per_clip`` frames at ``fps`` before
    the anticipated frame, partial batches."""

    def __init__(self, annotations_csv: str, label_space: Optional[dict] = None,
                 frames_per_clip: int = 16, fps: float = 5.0,
                 anticipation_time_range: tuple[float, float] = (0.25, 1.75),
                 anticipation_point_range: tuple[float, float] = (0.0, 0.25),
                 transform=None, batch_size: int = 8, rank: int = 0, world_size: int = 1,
                 worker_id: int = 0, num_workers: int = 1, training: bool = True,
                 partial_batches: bool = True, seed: int = 0):
        _, rows = read_annotations(annotations_csv)
        self.label_space = label_space or build_action_label_space(rows)
        self.by_video: dict[str, list[dict]] = {}
        for r in rows:
            self.by_video.setdefault(r["video_path"], []).append(r)
        self.shards = ResampledVideoShards(sorted(self.by_video), training=training)
        self.fpc = frames_per_clip
        self.fps = fps
        self.at_range = anticipation_time_range
        self.ap_range = anticipation_point_range
        self.transform = transform
        self.batch_size = batch_size
        self.rank = rank
        self.world_size = world_size
        self.worker_id = worker_id
        self.num_workers = num_workers
        self.training = training
        self.partial_batches = partial_batches
        self.seed = seed

    def set_epoch(self, epoch: int) -> None:
        self.shards.set_epoch(epoch)

    def _iter_shards(self):
        node = split_by_node(self.shards, self.rank, self.world_size)
        if self.num_workers > 1:  # wds.split_by_worker
            node = itertools.islice(node, self.worker_id, None, self.num_workers)
        yield from node

    def _decode_shard(self, path: str, rng: np.random.Generator):
        try:
            vr = VideoReader(str(path))
            vfps = vr.avg_fps
            fstp = max(1, int(vfps / self.fps))
            nframes = int(self.fpc * fstp)
        except (VideoReadError, OSError) as e:  # log_and_continue (`:57-60`)
            logger.warning("skipping unreadable shard %s: %s", path, e)
            return
        for row in self.by_video[path]:
            sf = float(row["start_sec"]) * vfps
            ef = float(row["stop_sec"]) * vfps
            at = float(rng.uniform(*self.at_range))
            aframes = int(at * vfps)
            ap = float(rng.uniform(*self.ap_range))
            # the anticipated frame between start and stop, less the horizon
            # (reference `epickitchens.py:126-137`)
            af = int(sf * ap + (1 - ap) * ef - aframes)
            indices = np.arange(af - nframes, af, fstp).astype(np.int64)
            indices[indices < 0] = 0  # pad with the first frame
            try:
                clip = vr.get_batch(indices)
            except (VideoReadError, OSError, IndexError) as e:
                logger.warning("skipping bad annotation in %s: %s", path, e)
                continue
            if self.transform is not None:
                clip = self.transform(clip, rng=rng)
            yield self._sample(clip, at, row)

    def __iter__(self):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.shards.epoch, self.rank, self.worker_id]))
        buf: list[AnticipationSample] = []
        for path in self._iter_shards():
            for sample in self._decode_shard(path, rng):
                buf.append(sample)
                if len(buf) == self.batch_size:
                    yield anticipation_collate(buf)
                    buf = []
        if buf and self.partial_batches:
            yield anticipation_collate(buf)
