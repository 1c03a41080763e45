"""The port's eval launcher (`vjepa2_tpu_torch/cli/eval.py`) against the JAX
package's (`vjepa2_tpu/cli/eval.py`): ``--tiny --device cpu`` end to end on
the shipped ViT-L configs (SSv2: the multiclip plugin; Diving-48: the
multilevel plugin with ``out_layers``; IN1K: the image plugin; EK100:
anticipation), `shrink_config` and the synthetic loaders equal to JAX's,
`chip_smoke.py`'s eval dicts equal to their YAML files, and the refusals:
image and EK100 paths set without ``--synthetic-data`` (ROADMAP A8c), several
processes, the pipeline-parallel checkpoint layout and Orbax directories
(ROADMAP A12), no card without ``--device cpu``. Checkpoints: a released
`.pt` and a `Pretrainer` checkpoint load their target encoder, and the EK100
runner takes its predictor from the same checkpoint file.

The tiny runs draw their own weights (torch cannot draw JAX's), so their
results are held to shape and range, not to JAX's numbers; the modules
under them are held to JAX in `test_torch_probes.py`, `test_torch_evals.py`
and `test_torch_anticipation.py`.
"""

import argparse
import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from vjepa2_tpu.cli import eval as jcli
from vjepa2_tpu_torch.cli import eval as cli
from vjepa2_tpu_torch.models.vision_transformer import vit_tiny

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ["ssv2", "diving48", "in1k", "ek100"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch ops: the tier-1 run puts 6
    pytest workers on an 8-core host, and torch's default 8 threads a worker
    oversubscribe it (six parallel copies of this file's tiny runs there:
    728 s with 8 threads each, 8 s with 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _yaml(name: str) -> dict:
    return yaml.safe_load((ROOT / f"configs/eval/vitl/{name}.yaml").read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_tiny_runs_on_the_cpu(name, capsys):
    result = cli.main(["--fname", str(ROOT / f"configs/eval/vitl/{name}.yaml"), "--tiny",
                       "--device", "cpu"])
    if name == "ek100":
        for head in ("verb", "noun", "action"):
            assert 0.0 <= result[head]["recall"] <= 100.0
            assert len(result["per_probe"][head]) == 2
    else:
        assert result["top1_per_probe"].shape == (2,)
        assert 0.0 <= result["top1"] <= 1.0 and result["best_probe"] in (0, 1)
    assert "{" in capsys.readouterr().out  # the printed summary


@pytest.mark.parametrize("name", CONFIGS + ["k400", "jester", "coin"])
def test_shrink_config_matches_jax(name):
    raw = _yaml(name)
    assert cli.shrink_config(copy.deepcopy(raw)) == jcli.shrink_config(copy.deepcopy(raw))


def test_synthetic_loader_matches_jax():
    got = list(cli.SyntheticEvalLoader(2, 2, 4, 16, 5, 3, seed=1))
    want = list(jcli.SyntheticEvalLoader(2, 2, 4, 16, 5, 3, seed=1))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["VIDEO", "ANTICIPATION", "IMAGE", "VIDEO_384"])
def test_chip_smoke_eval_configs_are_the_shipped_files(which):
    held = getattr(chip_smoke, f"EVAL_{which}_CONFIG")
    shipped = yaml.safe_load((ROOT / getattr(chip_smoke, f"EVAL_{which}_CONFIG_FILE")).read_text())
    assert held == shipped
    overrides = getattr(chip_smoke, f"EVAL_{which}_OVERRIDES", chip_smoke.EVAL_OVERRIDES)
    ipe = chip_smoke.EVAL_384_IPE if which == "VIDEO_384" else chip_smoke.EVAL_IPE
    ran = chip_smoke.overridden(held, overrides)
    opt = ran["experiment"]["optimization"]
    assert (opt["ipe"], opt["num_epochs"]) == (ipe, 1)
    # only the iterations are cut
    assert set(overrides) == {"experiment.optimization.ipe", "experiment.optimization.num_epochs"}


def test_tiny_vitg_384_k400_runs_on_the_cpu(capsys):
    """The ViT-g/384 K400 config (`configs/eval/vitg-384/k400.yaml`: the
    multiclip plugin with ``max_frames: 128``, which JAX's plugin also
    leaves unread with ``use_pos_embed`` off) through ``--tiny``."""
    result = cli.main(["--fname", str(ROOT / "configs/eval/vitg-384/k400.yaml"), "--tiny",
                       "--device", "cpu"])
    assert result["top1_per_probe"].shape == (2,)
    assert 0.0 <= result["top1"] <= 1.0
    assert "{" in capsys.readouterr().out


def test_ek100_probes_take_the_encoders_heads(monkeypatch):
    """JAX's launcher builds the anticipation probes with `AnticipationEval`'s
    default 12 heads, which do not divide ViT-L's 1024 (its CrossAttention
    reshape fails, shown here at that width); the port takes
    ``classifier.num_heads``, else the encoder's (3 at vit_tiny, 16 at
    ViT-L)."""
    import jax
    import jax.numpy as jnp

    from vjepa2_tpu.evals.action_anticipation import MultiHeadAttentiveClassifier

    jm = MultiHeadAttentiveClassifier(embed_dim=1024, num_heads=12, num_verbs=5, num_nouns=7,
                                      num_actions=9)
    with pytest.raises(TypeError, match="reshape"):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.ones((1, 8, 1024)))
    seen = {}
    from vjepa2_tpu_torch.evals import action_anticipation

    real = action_anticipation.AnticipationEval

    def spy(*args, **kwargs):
        seen["num_heads"] = kwargs["num_heads"]
        return real(*args, **kwargs)

    monkeypatch.setattr(action_anticipation, "AnticipationEval", spy)
    cli.main(["--fname", str(ROOT / "configs/eval/vitl/ek100.yaml"), "--tiny", "--device", "cpu"])
    assert seen["num_heads"] == 3


def _args(**kw):
    return argparse.Namespace(**{"checkpoint": None, "epochs": None, "synthetic_data": False,
                                 "val_only": False, "device": torch.device("cpu"), **kw})


@pytest.mark.parametrize("name, key", [("in1k", "root"), ("ek100", "annotations_train")])
def test_data_on_disk_is_refused_without_synthetic_data(name, key):
    raw = cli.shrink_config(_yaml(name))
    raw["experiment"]["data"][key] = "/data/train.csv"
    with pytest.raises(NotImplementedError, match="A8b"):
        cli.EVALS[raw["eval_name"]](raw, _args())
    out = cli.EVALS[raw["eval_name"]](copy.deepcopy(raw), _args(synthetic_data=True))
    assert out is not None


@pytest.mark.parametrize("flags", [["--num-processes", "2"], ["--process-id", "1"],
                                   ["--coordinator", "host:1234"]])
def test_several_processes_are_refused(flags):
    with pytest.raises(SystemExit, match="one card"):
        cli.main(["--fname", str(ROOT / "configs/eval/vitl/ssv2.yaml"), "--tiny",
                  "--device", "cpu", *flags])


def test_without_a_card_the_launcher_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device visible"):
        cli.main(["--fname", str(ROOT / "configs/eval/vitl/ssv2.yaml"), "--tiny"])


def _tiny_encoder_state(seed: int) -> dict:
    enc = vit_tiny(img_size=(64, 64), num_frames=4, uniform_power=True, use_rope=True)
    enc.reset_parameters(torch.Generator().manual_seed(seed))
    return enc.state_dict()


MODEL_KWARGS = {"pretrain_kwargs": {"model_name": "vit_tiny", "use_rope": True}}


def test_checkpoints_give_the_target_encoder(tmp_path):
    """A released `.pt` ("module."-prefixed entries, the target preferred)
    and the port's `Pretrainer` checkpoint directory (its latest step's
    target encoder) load with no conversion."""
    target, online = _tiny_encoder_state(1), _tiny_encoder_state(2)
    released = tmp_path / "vitl.pt"
    torch.save({"encoder": {f"module.{k}": v for k, v in online.items()},
                "target_encoder": {f"module.{k}": v for k, v in target.items()}}, released)
    folder = tmp_path / "ckpt"
    folder.mkdir()
    for step, sd in ((4, online), (8, target)):
        torch.save({"step": step, "encoder": online, "predictor": {}, "target_encoder": sd,
                    "optimizer": {}}, folder / f"{step}.pt")
    for path in (released, folder, folder / "8.pt"):
        enc = cli.build_encoder(MODEL_KWARGS, 64, 4, str(path), device="cpu")
        for k, v in enc.state_dict().items():
            assert torch.equal(v, target[k]), (path, k)


def test_anticipation_reads_encoder_and_predictor_from_one_checkpoint(tmp_path, monkeypatch):
    """The EK100 runner on a `Pretrainer` checkpoint directory: the encoder
    is the latest step's target encoder and the predictor that step's
    predictor (both frozen, so still the saved weights after training)."""
    target, online = _tiny_encoder_state(1), _tiny_encoder_state(2)
    holder = argparse.Namespace(embed_dim=192)
    saved = {}
    for step, seed in ((4, 3), (8, 4)):
        pred = cli.build_predictor(holder, 64, 4, device="cpu")
        pred.reset_parameters(torch.Generator().manual_seed(seed))
        saved[step] = pred.state_dict()
    folder = tmp_path / "ckpt"
    folder.mkdir()
    for step, sd in ((4, online), (8, target)):
        torch.save({"step": step, "encoder": online, "predictor": saved[step],
                    "target_encoder": sd, "optimizer": {}}, folder / f"{step}.pt")
    seen = {}
    from vjepa2_tpu_torch.evals import action_anticipation

    real = action_anticipation.AnticipationEval

    def spy(encoder, predictor, *args, **kwargs):
        seen.update(encoder=encoder, predictor=predictor)
        return real(encoder, predictor, *args, **kwargs)

    monkeypatch.setattr(action_anticipation, "AnticipationEval", spy)
    cli.main(["--fname", str(ROOT / "configs/eval/vitl/ek100.yaml"), "--tiny", "--device", "cpu",
              "--checkpoint", str(folder)])
    for model, want in ((seen["encoder"], target), (seen["predictor"], saved[8])):
        got = model.state_dict()
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[k], v), k


def test_jax_checkpoint_layouts_are_refused(tmp_path):
    pipeline = tmp_path / "pipeline.pt"
    torch.save({"target_params": {"encoder": {}, "encoder_blocks": {}}}, pipeline)
    orbax = tmp_path / "orbax"
    (orbax / "default").mkdir(parents=True)
    for path in (pipeline, orbax):
        with pytest.raises(NotImplementedError, match="A12"):
            cli.build_encoder(MODEL_KWARGS, 64, 4, str(path), device="cpu")


def test_vitg_384_rope_grid_and_wrapper_match_jax():
    """The ViT-g/384 config's geometry at a narrow width: 16 frames at
    384 px give a RoPE grid of 8 x 24 x 24 (4608 tokens a clip, heads of 64
    as `vit_giant_xformers`'s), encoded through the config's multiclip
    plugin with its ``wrapper_kwargs`` (``max_frames: 128``), port against
    JAX on the same weights."""
    import jax
    import jax.numpy as jnp

    from vjepa2_tpu.evals import plugins as jplugins
    from vjepa2_tpu.models.vision_transformer import VisionTransformer as JaxViT
    from vjepa2_tpu_torch.evals import plugins
    from vjepa2_tpu_torch.hub.converter import state_dict_from_flax
    from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer

    raw = _vitg_384()
    mdl = raw["model_kwargs"]
    data = raw["experiment"]["data"]
    res, fpc = data["resolution"], data["frames_per_clip"]
    cfg = dict(img_size=(res, res), patch_size=16, num_frames=fpc, tubelet_size=2,
               embed_dim=128, depth=1, num_heads=2, use_rope=True, uniform_power=True)
    jenc = JaxViT(**cfg)
    params = jax.jit(jenc.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, fpc, res, res, 3)))["params"]
    enc = VisionTransformer(**cfg)
    enc.load_state_dict(state_dict_from_flax(params))
    clips = np.random.RandomState(0).rand(1, 2, fpc, res, res, 3).astype(np.float32)
    jx = jplugins.init_module(mdl["module_name"], encoder=jenc, **mdl["wrapper_kwargs"])
    tx = plugins.init_module(mdl["module_name"], encoder=enc.eval(), **mdl["wrapper_kwargs"])
    want = np.asarray(jx(params, jnp.asarray(clips)))
    with torch.inference_mode():
        got = tx(torch.from_numpy(clips)).numpy()
    assert got.shape == want.shape == (1, 2 * 8 * 24 * 24, 128)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def _vitg_384() -> dict:
    return yaml.safe_load((ROOT / "configs/eval/vitg-384/k400.yaml").read_text())
