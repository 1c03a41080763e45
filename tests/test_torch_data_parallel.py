"""Training and evals across processes: the port's data- and context-parallel
steps against the JAX package's on a device mesh, and the CLIs on several
processes. Every rank is a spawned process on gloo over a FileStore in
``tmp_path``, one thread each; the functions the ranks run import no JAX.

* The pretrain step (`train.pretrain.make_train_step`, ``grad_group``) on 2
  ranks of 2 clips against JAX's jitted step on a ``data=2`` mesh of the 4
  clips, and against the port's one-process step at the whole batch, on the
  widths of `test_torch_pretrain_step.py` (encoder 192 / 3 heads, predictor
  64 / 2 heads, depth 2, RoPE, 4 frames at 64 px, fp32, the weights crossing
  with `state_dict_from_flax`); each rank takes its rows of the masks the
  collator draws for the 4 clips. Held as that file holds one step: the
  loss and grad norm rtol 1e-5, the gradients (the one-process step's)
  atol 1e-6 + 1e-4 of each leaf's largest entry, the EMA target atol 1e-6
  of JAX's; the parameters bit-equal on both ranks.
* The context-parallel step on 4 ranks (``data=2, model=2``: the ring over
  each pair) against JAX's step with `seq_sharded_attention` on a mesh of
  the same shape, on the models of JAX's
  `tests/train/test_context_parallel.py:39-52` (width 64, 2 heads of 32,
  16 frames at 64 px: 128 tokens; batch 8): the same tolerances; every
  rank's parameters bit-equal.
* The DROID step on 2 ranks against JAX's on a ``data=2`` mesh, on JAX's
  `tests/train/test_droid_multichip.py:42` shapes (vit_tiny with RoPE, the
  AC predictor 64 wide, depth 2; batch 8, 4 frames at 32 px): losses and
  grad norm rtol 1e-5, each predictor leaf within 1e-3 relative L2 of the
  update (as `test_torch_droid_step.py`), bit-equal ranks.
* ``cli.main --num-processes 2`` on the shipped ``smoke-tiny.yaml`` (an
  epoch of 8 steps, each rank 2 of the 4 clips): one checkpoint (rank 0's),
  a CSV a rank with the same losses, then a resume from it bit-equal to the
  file on both ranks, and a second epoch after which both ranks hold the
  same bits.
* ``cli.eval --tiny`` on 2 processes (the SSv2 config): the val counts summed
  over the ranks (`core.distributed.global_sum`), the probes bit-equal on
  both ranks and the result that of one process (both ranks probe the same
  synthetic clips). And the difference from JAX (ROADMAP queue C): on
  features that differ by rank, the port's `ProbeGrid` averages its
  gradients over the ranks, so both ranks make the one update of the
  whole batch's mean loss (within 1e-3 relative L2 of a one-process step's
  update on both ranks' features; bit-equal ranks; a step on one rank's
  features alone parts from it); JAX's probe step averages nothing across
  processes, so its ranks would part.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_distributed import spawn
from vjepa2_tpu_torch.core import distributed

ROOT = Path(__file__).resolve().parents[1]
RTOL, GRAD_ATOL, UPDATE_REL_L2 = 1e-5, 1e-6, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_sharded_step(mesh_axes, enc, pred, hp_kw, clips, me, mp, cp=False):
    """JAX's jitted pretrain step on a mesh: (the initial weights as the
    port's encoder and predictor state dicts, metrics, the state after)."""
    import jax
    import jax.numpy as jnp

    from vjepa2_tpu.core.mesh import MeshConfig, make_mesh
    from vjepa2_tpu.train import pretrain as jpre
    from vjepa2_tpu.train.state import TrainState as JaxState

    jclips = jnp.asarray(clips)
    jme, jmp = tuple(map(jnp.asarray, me)), tuple(map(jnp.asarray, mp))
    enc_vars = jax.jit(lambda k, c, m: enc.init(k, c, [m]))(jax.random.PRNGKey(0), jclips, jme[0])
    z0 = jax.jit(lambda v, c, m: enc.apply(v, c, [m]))(enc_vars, jclips, jme[0])
    pred_vars = jax.jit(lambda k, z, a, b: pred.init(k, z, a, b, 0))(
        jax.random.PRNGKey(1), z0, jme[0], jmp[0])
    weights = (_flax_sd(enc_vars), _flax_sd(pred_vars))  # before the step donates them
    params = {"encoder": enc_vars["params"], "predictor": pred_vars["params"]}
    target = jax.tree_util.tree_map(jnp.copy, enc_vars["params"])
    hp = jpre.PretrainHParams(**hp_kw)
    tx = jpre.make_optimizer(hp)
    mesh = mesh_axes if not isinstance(mesh_axes, tuple) else make_mesh(
        MeshConfig(*mesh_axes), devices=jax.devices()[:int(np.prod(mesh_axes))])
    state = jpre.shard_state(JaxState.create(params, target, tx), mesh, tp=not cp, cp=cp)
    step = jpre.jit_train_step(jpre.make_train_step(enc, pred, tx, hp), mesh)
    state, metrics = step(state, jclips, jme, jmp)
    metrics = {k: float(v) for k, v in jax.block_until_ready(metrics).items()}
    return weights, metrics, state


def _port_step(rank, world, enc_cfg, pred_cfg, hp_kw, weights, clips, me, mp, rows,
               group=None, cp=None):
    """The port's pretrain step on ``rows`` of the batch: (metrics, the
    gradients, the encoder and predictor after, the EMA target after)."""
    from vjepa2_tpu_torch.models.predictor import VisionTransformerPredictor
    from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer
    from vjepa2_tpu_torch.train import pretrain as tpre
    from vjepa2_tpu_torch.train.state import TrainState

    enc = VisionTransformer(**enc_cfg, cp_attend=cp)
    pred = VisionTransformerPredictor(**pred_cfg, cp_attend=cp)
    enc.load_state_dict(weights[0])
    pred.load_state_dict(weights[1])
    hp = tpre.PretrainHParams(**hp_kw)
    state = TrainState.create(enc, pred, tpre.make_optimizer(hp, enc, pred))
    grads = {}

    def keep_grads(opt_step, step):
        for prefix, m in (("encoder", enc), ("predictor", pred)):
            grads.update({f"{prefix}.{k}": p.grad.clone() for k, p in m.named_parameters()
                          if p.grad is not None})
        opt_step(step)

    state.optimizer.step = functools.partial(keep_grads, state.optimizer.step)
    metrics = tpre.make_train_step(hp, grad_group=group)(
        state, torch.from_numpy(clips[rows]), [torch.from_numpy(m[rows]) for m in me],
        [torch.from_numpy(m[rows]) for m in mp])
    metrics = {k: float(v) for k, v in metrics.items()}
    return (metrics, grads, {**{f"encoder.{k}": v for k, v in enc.state_dict().items()},
                             **{f"predictor.{k}": v for k, v in pred.state_dict().items()}},
            state.target_encoder.state_dict())


def _dp_rank(rank, world, *args):
    b = 4 // world
    return _port_step(rank, world, *args, rows=slice(rank * b, (rank + 1) * b),
                      group=distributed.world_group())


S, T = 64, 4
ENC = dict(img_size=(S, S), patch_size=16, num_frames=T, tubelet_size=2, embed_dim=192,
           depth=2, num_heads=3, uniform_power=True, use_rope=True, use_flash=True)
PRED = dict(img_size=(S, S), patch_size=16, num_frames=T, tubelet_size=2, embed_dim=192,
            predictor_embed_dim=64, depth=2, num_heads=2, uniform_power=True, use_rope=True,
            use_flash=True, use_mask_tokens=True, num_mask_tokens=2, zero_init_mask_tokens=False)
MASK_CFGS = [
    {"spatial_scale": (0.15, 0.15), "temporal_scale": (1.0, 1.0),
     "aspect_ratio": (0.75, 1.5), "num_blocks": 8},
    {"spatial_scale": (0.7, 0.7), "temporal_scale": (1.0, 1.0),
     "aspect_ratio": (0.75, 1.5), "num_blocks": 2},
]
HP = dict(ipe=100, epochs=10, warmup_epochs=1)


def _masks(cfgs, fpc, crop, batch):
    from vjepa2_tpu_torch.masks.multiblock3d import MaskCollator

    coll = MaskCollator(cfgs, dataset_fpcs=[fpc], crop_size=(crop, crop))
    coll.step()
    return coll(fpc, batch)


def _flax_sd(tree):
    from vjepa2_tpu_torch.hub.converter import state_dict_from_flax

    return {k: torch.as_tensor(np.asarray(v)) for k, v in state_dict_from_flax(tree).items()}


def _assert_bit_equal(dicts, what):
    for r, d in enumerate(dicts[1:], start=1):
        for k, v in d.items():
            assert torch.equal(v, dicts[0][k]), f"{what} {k} on rank {r}"


def _assert_grads(got, want):
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        tol = GRAD_ATOL + 1e-4 * want[k].abs().max().item()
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=tol, rtol=1e-4, err_msg=k)


def test_data_parallel_step_matches_jax_and_one_process(tmp_path):
    from vjepa2_tpu.models.predictor import VisionTransformerPredictor as JaxPredictor
    from vjepa2_tpu.models.vision_transformer import VisionTransformer as JaxViT

    me, mp = _masks(MASK_CFGS, T, S, 4)
    clips = np.random.RandomState(0).rand(4, T, S, S, 3).astype(np.float32)
    jenc = JaxViT(**dict(ENC, use_flash=False))
    jpred = JaxPredictor(**dict(PRED, use_flash=False))
    weights, jm, jstate = _jax_sharded_step((2, 1, 1, 1), jenc, jpred, HP, clips, me, mp)
    one = _port_step(0, 1, ENC, PRED, HP, weights, clips, me, mp, slice(None))
    ranks = spawn(_dp_rank, 2, tmp_path, ENC, PRED, HP, weights, clips, me, mp)
    _assert_bit_equal([r[2] for r in ranks], "parameter")
    _assert_bit_equal([r[3] for r in ranks], "target")
    target_j = _flax_sd(jstate.target_params)
    for metrics, grads, _, target in ranks:
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(metrics[k], jm[k], rtol=RTOL, err_msg=k)
            np.testing.assert_allclose(metrics[k], one[0][k], rtol=RTOL, err_msg=k)
        _assert_grads(grads, one[1])
        for k, t in target.items():
            np.testing.assert_allclose(t.numpy(), target_j[k].numpy(), atol=1e-6, err_msg=k)


CP_S, CP_T = 64, 16
CP_ENC = dict(img_size=(CP_S, CP_S), patch_size=16, num_frames=CP_T, tubelet_size=2,
              embed_dim=64, depth=2, num_heads=2, use_rope=True)
CP_PRED = dict(img_size=(CP_S, CP_S), patch_size=16, num_frames=CP_T, tubelet_size=2,
               embed_dim=64, predictor_embed_dim=64, depth=1, num_heads=2,
               use_mask_tokens=True, num_mask_tokens=1, use_rope=True)
CP_MASKS = [{"spatial_scale": (0.7, 0.7), "temporal_scale": (1.0, 1.0),
             "aspect_ratio": (0.75, 1.5), "num_blocks": 2}]
CP_HP = dict(epochs=1, ipe=10, warmup_epochs=0)


def _cp_rank(rank, world, *args):
    from vjepa2_tpu_torch.core.mesh import MeshConfig, data_group, make_mesh, model_group
    from vjepa2_tpu_torch.ops.ring_attention import seq_sharded_attention

    mesh = make_mesh(MeshConfig(data=2, model=2), device_type="cpu")
    d = mesh.get_local_rank("data")
    return _port_step(rank, world, *args, rows=slice(4 * d, 4 * d + 4),
                      group=data_group(mesh), cp=seq_sharded_attention(model_group(mesh)))


def test_context_parallel_step_matches_jax(tmp_path):
    import jax

    from vjepa2_tpu.core.mesh import MeshConfig, make_mesh
    from vjepa2_tpu.models.predictor import VisionTransformerPredictor as JaxPredictor
    from vjepa2_tpu.models.vision_transformer import VisionTransformer as JaxViT
    from vjepa2_tpu.ops.ring_attention import seq_sharded_attention as jax_ring

    me, mp = _masks(CP_MASKS, CP_T, CP_S, 8)
    clips = np.random.RandomState(0).rand(8, CP_T, CP_S, CP_S, 3).astype(np.float32)
    mesh = make_mesh(MeshConfig(data=2, fsdp=1, model=2), devices=jax.devices()[:4])
    ring = jax_ring(mesh, "model")
    jenc, jpred = JaxViT(**CP_ENC, cp_attend=ring), JaxPredictor(**CP_PRED, cp_attend=ring)
    weights, jm, jstate = _jax_sharded_step(mesh, jenc, jpred, CP_HP, clips, me, mp, cp=True)
    enc_cfg, pred_cfg = dict(CP_ENC, use_flash=True), dict(CP_PRED, use_flash=True)
    ranks = spawn(_cp_rank, 4, tmp_path, enc_cfg, pred_cfg, CP_HP, weights, clips, me, mp)
    _assert_bit_equal([r[2] for r in ranks], "parameter")
    target_j = _flax_sd(jstate.target_params)
    for metrics, _, _, target in ranks:
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(metrics[k], jm[k], rtol=RTOL, err_msg=k)
        for k, t in target.items():
            np.testing.assert_allclose(t.numpy(), target_j[k].numpy(), atol=1e-6, err_msg=k)


D_B, D_T, D_S = 8, 4, 32
D_ENC = dict(img_size=(D_S, D_S), num_frames=2, tubelet_size=2, use_rope=True)
D_PRED = dict(img_size=(D_S, D_S), patch_size=16, embed_dim=192, predictor_embed_dim=64,
              depth=2, num_heads=2)
D_HP = dict(lr=1e-3, start_lr=1e-3, warmup_steps=0, anneal_steps=10, total_steps=100,
            auto_steps=2)


def _droid_batch():
    rs = np.random.RandomState(0)
    return (rs.rand(D_B, D_T, D_S, D_S, 3).astype(np.float32),
            (rs.rand(D_B, D_T - 1, 7) * 0.1).astype(np.float32),
            rs.rand(D_B, D_T, 7).astype(np.float32))


def _droid_rank(rank, world, weights):
    from vjepa2_tpu_torch.models.ac_predictor import vit_ac_predictor
    from vjepa2_tpu_torch.models.vision_transformer import vit_tiny
    from vjepa2_tpu_torch.train import droid as tdroid

    enc = vit_tiny(**D_ENC, use_flash=True).requires_grad_(False)
    pred = vit_ac_predictor(**D_PRED, use_flash=True)
    enc.load_state_dict(weights[0])
    pred.load_state_dict(weights[1])
    hp = tdroid.DroidHParams(**D_HP)
    state = tdroid.DroidState(0, pred, enc, tdroid.make_droid_optimizer(hp, pred))
    b = D_B // world
    rows = slice(rank * b, (rank + 1) * b)
    step = tdroid.make_droid_train_step(hp, tdroid.tokens_per_frame(enc),
                                        grad_group=distributed.world_group())
    metrics = step(state, *(torch.from_numpy(x[rows]) for x in _droid_batch()))
    return {k: float(v) for k, v in metrics.items()}, pred.state_dict()


def test_droid_step_on_two_ranks_matches_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from vjepa2_tpu.core.mesh import MeshConfig, make_mesh
    from vjepa2_tpu.models.ac_predictor import vit_ac_predictor as jax_ac
    from vjepa2_tpu.models.vision_transformer import vit_tiny as jax_tiny
    from vjepa2_tpu.train import droid as jdroid
    from vjepa2_tpu.train.pretrain import shard_state
    from vjepa2_tpu.train.state import TrainState as JaxState

    encoder = jax_tiny(**D_ENC)
    predictor = jax_ac(**D_PRED, num_frames=2 * D_T, tubelet_size=2)
    hp = jdroid.DroidHParams(**D_HP)
    params, enc_params, tpf = jdroid.init_droid_params(encoder, predictor, 0,
                                                       (D_B, D_T, D_S, D_S, 3))
    tx = jdroid.make_droid_optimizer(hp, params_like=params)
    state = JaxState(step=jnp.zeros([], jnp.int32), params=params, target_params=enc_params,
                     opt_state=tx.init(params))
    mesh = make_mesh(MeshConfig(data=2, fsdp=1, model=1), devices=jax.devices()[:2])
    step = jdroid.jit_droid_train_step(
        jdroid.make_droid_train_step(encoder, predictor, tx, hp, tpf), mesh)
    weights = (_flax_sd(enc_params), _flax_sd(params["predictor"]))  # before the donation
    new, jm = step(shard_state(state, mesh), *_droid_batch(), None)
    jm = {k: float(v) for k, v in jax.block_until_ready(jm).items()}
    before, after = weights[1], _flax_sd(new.params["predictor"])

    ranks = spawn(_droid_rank, 2, tmp_path, weights)
    _assert_bit_equal([r[1] for r in ranks], "predictor")
    for metrics, got in ranks:
        for k in ("loss", "loss_teacher_forcing", "loss_rollout", "grad_norm"):
            np.testing.assert_allclose(metrics[k], jm[k], rtol=RTOL, err_msg=k)
        for k, p in got.items():
            update = (after[k] - before[k]).norm()
            assert (p - after[k]).norm() <= UPDATE_REL_L2 * update, k


def _cli_rank(rank, world, store, cfg_path):
    """Rank ``rank`` of the CLI run: an epoch through ``cli.main``, then a
    resume of it and a second epoch through the `Pretrainer`."""
    import yaml

    from vjepa2_tpu_torch.cli import main as cli
    from vjepa2_tpu_torch.core.config import PretrainConfig
    from vjepa2_tpu_torch.train.loop import Pretrainer

    torch.set_num_threads(1)
    flags = ["--num-processes", str(world), "--process-id", str(rank), "--device", "cpu"]
    first = cli.main(["--fname", cfg_path, "--coordinator", f"file://{store}-1",
                      "--epochs", "1", *flags])
    assert not distributed.initialized()  # the CLI left its group
    distributed.init_distributed(f"file://{store}-2", world, rank, device="cpu")
    raw = yaml.safe_load(Path(cfg_path).read_text())
    raw["meta"]["load_checkpoint"] = True
    trainer = Pretrainer(PretrainConfig.from_dict(raw), device="cpu")
    state = trainer.restore_or_init()
    restored = {k: v.clone() for k, v in state.encoder.state_dict().items()}
    second = trainer.run(epochs=2)
    distributed.destroy()
    return first, restored, second, {k: v.clone() for k, v in state.encoder.state_dict().items()}


def _cli_main(rank, world, store, cfg_path, out_dir):
    out = _cli_rank(rank, world, store, cfg_path)
    torch.save(out, f"{out_dir}/out{rank}.pt")


def _spawn_plain(fn, world, tmp_path, *args):
    torch.multiprocessing.start_processes(fn, (world, *args, str(tmp_path)), nprocs=world,
                                          join=True, start_method="spawn")
    return [torch.load(tmp_path / f"out{r}.pt", weights_only=False) for r in range(world)]


def _csv_losses(path):
    """The loss column of a run's CSV (each run appends its own header)."""
    return [line.split(",")[2] for line in path.read_text().splitlines()
            if line.split(",")[0].isdigit()]


def test_cli_main_on_two_processes_runs_and_resumes(tmp_path):
    import yaml

    raw = yaml.safe_load((ROOT / "configs/train/smoke-tiny.yaml").read_text())
    raw["folder"] = str(tmp_path / "run")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    outs = _spawn_plain(_cli_main, 2, tmp_path, str(tmp_path / "store"), str(cfg))
    ipe = raw["optimization"]["ipe"]
    ckpts = sorted((tmp_path / "run" / "ckpt").iterdir(), key=lambda p: int(p.stem))
    assert [p.name for p in ckpts] == [f"{ipe}.pt", f"{2 * ipe}.pt"]
    saved = torch.load(ckpts[0], weights_only=True)["encoder"]
    for first, restored, second, final in outs:
        assert first["step"] == ipe and second["step"] == 2 * ipe
        assert np.isfinite(first["loss"]) and first["loss"] == outs[0][0]["loss"]
        for k, v in saved.items():
            assert torch.equal(restored[k], v), k
        final_saved = torch.load(ckpts[1], weights_only=True)["encoder"]
        for k, v in final.items():
            assert torch.equal(v, final_saved[k]), k
    rows = [_csv_losses(tmp_path / "run" / f"log_r{r}.csv") for r in range(2)]
    assert len(rows[0]) == 2 * ipe and rows[0] == rows[1]


def _eval_rank(rank, world, store, out_dir):
    """``cli.eval --tiny`` on this rank, the global_sum calls it makes
    recorded; then a `ProbeGrid` step on features that differ by rank."""
    from vjepa2_tpu_torch.cli import eval as cli_eval
    from vjepa2_tpu_torch.evals import video_classification as vc

    torch.set_num_threads(1)
    sums = []
    real_sum, real_run = vc.global_sum, vc.VideoClassificationEval.run

    def recording_sum(x):
        out = real_sum(x)
        sums.append((np.asarray(x).copy(), np.asarray(out).copy()))
        return out

    def run(self, *a, **k):
        out = real_run(self, *a, **k)
        out["probes"] = {n: v.clone() for n, v in self._probe_state[0].items()}
        return out

    vc.global_sum, vc.VideoClassificationEval.run = recording_sum, run
    result = cli_eval.main(["--fname", str(ROOT / "configs/eval/vitl/ssv2.yaml"), "--tiny",
                            "--device", "cpu", "--coordinator", f"file://{store}-eval",
                            "--num-processes", str(world), "--process-id", str(rank)])
    distributed.init_distributed(f"file://{store}-grid", world, rank, device="cpu")
    grid = _grid_step(_grid_feats()[rank])
    distributed.destroy()
    torch.save((result, sums, grid), f"{out_dir}/out{rank}.pt")


def _grid_feats():
    rs = np.random.RandomState(5)
    return [(torch.from_numpy(rs.randn(3, 8, 32).astype(np.float32)),
             torch.from_numpy(rs.randint(0, 4, 3))) for _ in range(2)]


def _grid_step(feats_labels):
    from vjepa2_tpu_torch.evals.probes import ProbeConfig, ProbeGrid

    grid = ProbeGrid([ProbeConfig(lr=1e-3, weight_decay=0.01), ProbeConfig(lr=3e-3,
                                                                         weight_decay=0.0)],
                     embed_dim=32, num_classes=4, num_heads=2, total_steps=10, device="cpu")
    params, opt, step = grid.init()
    if feats_labels is not None:
        params, opt, step, _ = grid.train_step(params, opt, step, *feats_labels)
    return params


def test_cli_eval_on_two_processes_sums_counts_and_averages_probes(tmp_path):
    from vjepa2_tpu_torch.cli import eval as cli_eval

    outs = _spawn_plain(_eval_rank, 2, tmp_path, str(tmp_path / "store"))
    one = cli_eval.main(["--fname", str(ROOT / "configs/eval/vitl/ssv2.yaml"), "--tiny",
                         "--device", "cpu"])
    (r0, sums0, grid0), (r1, sums1, grid1) = outs
    # the counts of the val pass, summed over both ranks
    assert len(sums0) == len(sums1) == 2
    for (x0, y0), (x1, y1) in zip(sums0, sums1):
        np.testing.assert_array_equal(y0, x0 + x1)
        np.testing.assert_array_equal(y1, x0 + x1)
    np.testing.assert_array_equal(r0["top1_per_probe"], one["top1_per_probe"])
    for k, v in r0["probes"].items():
        assert torch.equal(v, r1["probes"][k]), k
    # features that differ by rank: one update, the whole batch's
    _assert_bit_equal([grid0, grid1], "probe")
    feats = _grid_feats()
    both = _grid_step((torch.cat([feats[0][0], feats[1][0]]),
                       torch.cat([feats[0][1], feats[1][1]])))
    alone = _grid_step(feats[0])
    init = _grid_step(None)
    for k, v in grid0.items():
        update = (both[k] - init[k]).norm()
        assert (v - both[k]).norm() <= UPDATE_REL_L2 * update, k
    assert any((grid0[k] - alone[k]).norm() > 0.1 * (alone[k] - init[k]).norm() for k in grid0)
