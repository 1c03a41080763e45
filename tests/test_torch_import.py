"""The port stands apart from JAX: importing every module of
`vjepa2_tpu_torch` leaves jax (and the JAX package) out of `sys.modules`, and
the kernel build raises, rather than falls back, where nvcc is missing."""

import subprocess
import sys
from pathlib import Path

import pytest

from vjepa2_tpu_torch import _build

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, pkgutil, sys
import vjepa2_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vjepa2_tpu_torch.__path__, "vjepa2_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "vjepa2_tpu"))
missing = {"vjepa2_tpu_torch.ops.flash_attention", "vjepa2_tpu_torch.core.device",
           "vjepa2_tpu_torch.core.config", "vjepa2_tpu_torch.core.logging",
           "vjepa2_tpu_torch.core.provenance", "vjepa2_tpu_torch.core.checkpoint",
           "vjepa2_tpu_torch.train.accum", "vjepa2_tpu_torch.train.loop",
           "vjepa2_tpu_torch.data.video", "vjepa2_tpu_torch.data.prefetch",
           "vjepa2_tpu_torch.cli.main", "vjepa2_tpu_torch.models.ac_predictor",
           "vjepa2_tpu_torch.train.droid", "vjepa2_tpu_torch.train.droid_loop",
           "vjepa2_tpu_torch.planning", "vjepa2_tpu_torch.planning.cem",
           "vjepa2_tpu_torch.planning.rotations", "vjepa2_tpu_torch.planning.world_model",
           "vjepa2_tpu_torch.hub.backbones", "vjepa2_tpu_torch.hub.converter",
           "vjepa2_tpu_torch.evals.wrappers", "vjepa2_tpu_torch.evals.probes",
           "vjepa2_tpu_torch.evals.plugins", "vjepa2_tpu_torch.evals.video_classification",
           "vjepa2_tpu_torch.evals.image_classification",
           "vjepa2_tpu_torch.evals.action_anticipation", "vjepa2_tpu_torch.cli.eval",
           "vjepa2_tpu_torch.core.monitoring", "vjepa2_tpu_torch.data.native",
           "vjepa2_tpu_torch.data.augment", "vjepa2_tpu_torch.data.samplers",
           "vjepa2_tpu_torch.data.video_dataset", "vjepa2_tpu_torch.data.loader",
           "vjepa2_tpu_torch.data.manager"} - set(names)
print(len(names), bad, sorted(missing))
sys.exit(1 if bad or missing or len(names) < 10 else 0)
"""


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
