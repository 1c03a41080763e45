"""The port's ImageNet folders (`vjepa2_tpu_torch/data/imagenet.py`,
`data/manager.py` `init_image_data`) and `cli.eval`'s IN1K run from
``root`` / ``root_val`` against the JAX package's on the same files.

JPEGs of several sizes written with PIL in ``tmp_path`` (3 classes, a
subset file naming 2). Checked: `ImageFolder`'s classes and samples with
and without the subset file, its decoded images bit-equal; val batches
through `init_image_data` bit-equal (centre crops draw nothing); train
batches' crops and flips equal when JAX's transform is handed the generator
the port's dataset draws from, the pixels within one level of JAX's cv2
resize (the port's numpy `INTER_LINEAR`, held so by
`tests/test_torch_transforms.py`); `init_data`'s imagenet branch;
`cli.eval`'s IN1K eval from the folders at `shrink_config` size through 2
spawned workers. JAX's unseeded train crops are pinned (ROADMAP queue C)."""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from test_torch_transforms import _close as close
from vjepa2_tpu.data import imagenet as jim
from vjepa2_tpu.data import loader as jloader
from vjepa2_tpu.data import manager as jmanager
from vjepa2_tpu.data import samplers as js
from vjepa2_tpu.data import transforms as jt
from vjepa2_tpu_torch.cli import eval as cli
from vjepa2_tpu_torch.data import imagenet as tim
from vjepa2_tpu_torch.data import manager as tmanager
from vjepa2_tpu_torch.data import transforms as tt

Image = pytest.importorskip("PIL.Image", reason="the test images are written with PIL")
ROOT = Path(__file__).resolve().parents[1]
WNIDS = ("n01440764", "n01443537", "n01484850")
SIZES = ((40, 52), (61, 37), (48, 48))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_folder(root: Path, images_per_class: int, seed: int) -> str:
    """``root/<wnid>/<i>.JPEG`` (random RGB, the sizes cycling), plus a
    stray text file that is no image."""
    rng = np.random.default_rng(seed)
    for c, wnid in enumerate(WNIDS):
        (root / wnid).mkdir(parents=True)
        for i in range(images_per_class):
            h, w = SIZES[(c + i) % len(SIZES)]
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            Image.fromarray(img).save(root / wnid / f"{wnid}_{i}.JPEG", quality=90)
    (root / WNIDS[0] / "notes.txt").write_text("not an image")
    return str(root)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("in1k")
    subset = root / "subset.txt"
    subset.write_text(f"{WNIDS[2]} tench\n\n{WNIDS[0]} goldfish\nn99999999 absent\n")
    return {"train": write_folder(root / "train", 4, seed=0),
            "val": write_folder(root / "val", 2, seed=1), "subset": str(subset)}


@pytest.mark.parametrize("subset", [False, True])
def test_image_folder_matches_jax(data, subset):
    kw = {"subset_file": data["subset"] if subset else None}
    port, jax = tim.ImageFolder(data["train"], **kw), jim.ImageFolder(data["train"], **kw)
    assert port.class_to_idx == jax.class_to_idx
    assert port.samples == jax.samples and len(port) == (8 if subset else 12)
    assert {y for _, y in port.samples} == ({0, 2} if subset else {0, 1, 2})
    for i in (0, len(port) - 1):
        got, want = port[i], jax[i]
        assert got[1] == want[1] and got[0].dtype == want[0].dtype == np.uint8
        np.testing.assert_array_equal(got[0], want[0])


def _batches_equal(got, want, n, exact=True):
    assert len(got) == len(want) == n
    for (gi, gl), (wi, wl) in zip(got, want):
        close(gi, wi, exact=exact)
        np.testing.assert_array_equal(gl, wl)


def test_val_batches_match_jax(data):
    """The whole val folder in order, centre crops at 32 px, full batches."""
    kw = dict(batch_size=2, train=False, num_workers=0)
    _, tl, _ = tmanager.init_image_data(
        data["val"], transform=tt.ImageTransform(crop_size=32, train=False), **kw)
    _, jl, _ = jmanager.init_image_data(
        data["val"], transform=jt.ImageTransform(crop_size=32, train=False), **kw)
    _batches_equal(list(tl), list(jl), 3)


def test_train_batches_match_jax_under_one_generator(data):
    """Random resized crops and flips: the port's dataset draws from its
    ``rng``; JAX's transform is handed a generator of the same seed, read
    in the same order (JAX draws from no seeded one, see below). The crops
    resize up, where the port's numpy resize is within one level of cv2's."""
    transform = dict(crop_size=32, train=True)
    ds, loader, _ = tmanager.init_image_data(
        data["train"], 4, transform=tt.ImageTransform(**transform), num_workers=0, seed=3,
        ipe=2)
    shared = np.random.default_rng(3)
    jtf = jt.ImageTransform(**transform)
    jds = jim.ImageFolder(data["train"], transform=lambda img: jtf(img, rng=shared))
    jl = jloader.DataLoader(jds, js.DistributedSampler(len(jds), 1, 0, shuffle=True, seed=3),
                            batch_size=4, collate_fn=tim.image_collate, epoch_len=2)
    _batches_equal(list(loader), list(jl), 2, exact=False)


def test_imagenet_train_crops_jax_draws_unseeded(data):
    """JAX's `ImageFolder` calls the transform with no generator, so each
    training crop comes from a fresh unseeded `default_rng()`: two datasets
    built alike crop the same image differently, whatever numpy's global
    seed (ROADMAP queue C). The port's, built with one seed, agree."""
    transform = dict(crop_size=32, train=True)
    crops = []
    for _ in range(2):
        np.random.seed(0)
        crops.append(jim.ImageFolder(data["train"], transform=jt.ImageTransform(**transform))[0][0])
    assert not np.array_equal(*crops)
    port = [tim.ImageFolder(data["train"], transform=tt.ImageTransform(**transform), seed=5)[0][0]
            for _ in range(2)]
    np.testing.assert_array_equal(*port)


def test_init_data_dispatches_imagenet(data):
    ds, loader, sampler = tmanager.init_data(
        "imagenet", root=data["val"], batch_size=3, train=False, num_workers=0,
        transform=tt.ImageTransform(crop_size=32))
    assert isinstance(ds, tim.ImageFolder) and len(sampler) == 6
    images, labels = next(iter(loader))
    assert images.shape == (3, 32, 32, 3) and labels.tolist() == [0, 0, 1]


def test_cli_eval_reads_imagenet_folders(data):
    """The shipped IN1K config, shrunk as ``--tiny`` shrinks it, on the
    folders through 2 spawned workers: 2 train steps of 2 images, the 6 val
    images in 3 batches; top-1 per probe in [0, 1]."""
    raw = cli.shrink_config(yaml.safe_load((ROOT / "configs/eval/vitl/in1k.yaml").read_text()))
    raw["experiment"]["data"].update(root=data["train"], root_val=data["val"], num_workers=2)
    args = cli.argparse.Namespace(checkpoint=None, epochs=None, synthetic_data=False,
                                  val_only=False, device=torch.device("cpu"))
    out = cli.EVALS[raw["eval_name"]](copy.deepcopy(raw), args)
    assert len(out["top1_per_probe"]) == 2
    assert all(0.0 <= t <= 1.0 for t in out["top1_per_probe"])
