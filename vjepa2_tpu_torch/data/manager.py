"""Data dispatcher (counterpart of `vjepa2_tpu/data/manager.py`; reference
`src/datasets/data_manager.py:init_data`): video manifests to a dataset, its
sampler and a `DataLoader`. ImageNet folders (`init_image_data`) are not
ported yet (ROADMAP A8c)."""

from __future__ import annotations

from typing import Optional, Sequence

from vjepa2_tpu_torch.data.loader import DataLoader, FpcBucketSampler
from vjepa2_tpu_torch.data.samplers import (DistributedSampler,
                                            MemoryEfficientDistributedWeightedSampler)
from vjepa2_tpu_torch.data.video_dataset import VideoDataset


def init_video_data(
    data_paths: Sequence[str],
    batch_size: int,
    transform=None,
    shared_transform=None,
    datasets_weights: Optional[Sequence[float]] = None,
    dataset_fpcs: Optional[Sequence[int]] = None,
    frames_per_clip: int = 16,
    fps: Optional[int] = None,
    frame_step: Optional[int] = None,
    duration: Optional[float] = None,
    num_clips: int = 1,
    num_workers: int = 4,
    world_size: int = 1,
    rank: int = 0,
    drop_last: bool = True,
    ordered: bool = False,
    ipe: Optional[int] = None,
    seed: int = 0,
):
    """(dataset, loader, sampler) of `VideoDataset` over ``data_paths``: a
    weighted infinite sampler with ``datasets_weights``, else a shuffled
    epoch sampler; batches of one fpc each where the datasets' fpcs differ;
    ``ipe`` batches an epoch."""
    if fps is None and frame_step is None and duration is None:
        frame_step = 4
    dataset = VideoDataset(
        data_paths=data_paths, datasets_weights=datasets_weights,
        frames_per_clip=frames_per_clip, dataset_fpcs=dataset_fpcs, fps=fps,
        frame_step=frame_step, duration=duration, num_clips=num_clips, transform=transform,
        shared_transform=shared_transform, seed=seed)
    if datasets_weights is not None:
        sampler = MemoryEfficientDistributedWeightedSampler(
            dataset.num_samples_per_dataset, list(datasets_weights), world_size, rank, seed=seed)
    else:
        sampler = DistributedSampler(len(dataset), world_size, rank, seed=seed)
    batch_sampler = None
    if dataset_fpcs is not None and len(set(dataset_fpcs)) > 1:
        # mixed frames-per-clip: one fpc a batch (one step function a bucket)
        batch_sampler = FpcBucketSampler(sampler, dataset.fpc_for_index, batch_size)
    loader = DataLoader(dataset, sampler, batch_size=batch_size, num_workers=num_workers,
                        drop_last=drop_last, ordered=ordered, seed=seed, epoch_len=ipe,
                        batch_sampler=batch_sampler, rank=rank)
    return dataset, loader, sampler


def init_data(dataset_type: str = "VideoDataset", **kwargs):
    """Dispatch on ``dataset_type`` (reference `data_manager.py:42-88`)."""
    if dataset_type.lower() in ("videodataset", "video"):
        return init_video_data(**kwargs)
    if dataset_type.lower() in ("imagenet", "imagefolder"):
        raise NotImplementedError("ImageNet folders (init_image_data) are not ported yet "
                                  "(ROADMAP A8c): the port reads video manifests")
    raise ValueError(f"unknown dataset_type {dataset_type}")
