"""ImageNet-1K folders (counterpart of `vjepa2_tpu/data/imagenet.py`;
reference `src/datasets/imagenet1k.py`).

The layout is ``root/<wnid>/<image>``: the classes are the sorted
subdirectories, the images each class's sorted files. An optional subset
file keeps the classes named first on its lines (reference `ImageNetSubset`,
`imagenet1k.py:60-108`). Images decode with PIL to uint8 [H, W, 3] RGB.

The transform draws from the dataset's ``rng``, which the loader's workers
seed from their own streams (`loader.seed_worker`). JAX calls the transform
with no generator, so each of its training crops comes from a fresh unseeded
`default_rng()` and no run repeats another (ROADMAP queue C); an eval
transform draws nothing, and there both give the same images.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class ImageFolder:
    IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")

    def __init__(self, root: str, transform=None, subset_file: Optional[str] = None,
                 seed: int = 0):
        self.root = root
        self.transform = transform
        self.rng = np.random.default_rng(seed)
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: list[tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            self.samples += [(os.path.join(cdir, f), self.class_to_idx[c])
                             for f in sorted(os.listdir(cdir))
                             if f.lower().endswith(self.IMG_EXTS)]
        if subset_file is not None:
            with open(subset_file) as f:
                keep = {parts[0] for parts in (ln.split() for ln in f) if parts}
            keep_idx = {self.class_to_idx[c] for c in keep if c in self.class_to_idx}
            self.samples = [(p, y) for p, y in self.samples if y in keep_idx]

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int):
        from PIL import Image

        path, label = self.samples[index]
        with Image.open(path) as im:
            img = np.asarray(im.convert("RGB"))
        if self.transform is not None:
            img = self.transform(img, rng=self.rng)
        return img, label


def image_collate(samples):
    """[(image, label), ...] -> (images [B, H, W, 3], labels [B])."""
    return np.stack([s[0] for s in samples]), np.asarray([s[1] for s in samples])
