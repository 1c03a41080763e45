"""The port's planning (`vjepa2_tpu_torch.planning`) against the JAX
package's (`vjepa2_tpu/planning`): the rotations, `make_cem` and the
`WorldModel`, on the CPU.

The noise: torch cannot reproduce ``jax.random.normal``, so the port's CEM
takes a ``sampler``. `_jax_draws` replays `make_cem`'s key splits (per CEM
step and rollout frame: ``rng, k = split(rng)``, then ``normal(k, (S, 4))``)
after ``vjepa2_tpu`` is imported, so the PRNG implementation it sets (rbg)
is in force, and feeds those draws to the port. Both sides then rank the
same candidates.

Tolerances: the rotations within 1e-6 of JAX's and scipy's, `pose_diff`
inverting `compose_pose` within 1e-5 (JAX's own test); the CEM over the
linear world model of `tests/planning/test_cem.py` within 1e-6; the tiny
world model's encode and step_fn within JAX's AC tolerances (atol 3e-5,
rtol 2e-4, as `tests/test_torch_ac_predictor.py`), its plan within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from vjepa2_tpu.models.ac_predictor import VisionTransformerPredictorAC as JaxACPredictor
from vjepa2_tpu.models.vision_transformer import VisionTransformer as JaxViT
from vjepa2_tpu.planning import cem as jcem
from vjepa2_tpu.planning import rotations as jrot
from vjepa2_tpu.planning.world_model import WorldModel as JaxWorldModel
from vjepa2_tpu.train.droid import feature_layernorm as jax_feature_layernorm
from vjepa2_tpu_torch.hub.converter import load_world_model_state
from vjepa2_tpu_torch.models import modules
from vjepa2_tpu_torch.models.ac_predictor import vit_ac_predictor
from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer
from vjepa2_tpu_torch.planning import cem as tcem
from vjepa2_tpu_torch.planning import rotations as trot
from vjepa2_tpu_torch.planning.world_model import WorldModel

ATOL, RTOL = 3e-5, 2e-4


def _jax_draws(seed: int, cfg) -> np.ndarray:
    """[cem_steps, rollout, samples, 4]: the normals JAX's CEM draws from
    ``PRNGKey(seed)``, in its order of key splits (`cem.py:56`)."""
    rng = jax.random.PRNGKey(seed)
    out = np.empty((cfg.cem_steps, cfg.rollout, cfg.samples, 4), np.float32)
    for step in range(cfg.cem_steps):
        for h in range(cfg.rollout):
            rng, k = jax.random.split(rng)
            out[step, h] = np.asarray(jax.random.normal(k, (cfg.samples, 4)))
    return out


def _sampler(draws: np.ndarray):
    return lambda step, h: torch.from_numpy(draws[step, h])


# -- rotations ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_rotations_match_jax_and_scipy(seed):
    rs = np.random.RandomState(seed)
    eul = rs.uniform(-1.0, 1.0, size=(6, 3)).astype(np.float32)
    R = trot.euler_xyz_to_matrix(torch.from_numpy(eul)).numpy()
    np.testing.assert_allclose(R, np.asarray(jrot.euler_xyz_to_matrix(jnp.asarray(eul))),
                               atol=1e-6)
    np.testing.assert_allclose(R, Rotation.from_euler("xyz", eul).as_matrix(), atol=1e-6)
    back = trot.matrix_to_euler_xyz(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(back, np.asarray(jrot.matrix_to_euler_xyz(jnp.asarray(R))),
                               atol=1e-6)
    np.testing.assert_allclose(back, Rotation.from_matrix(R).as_euler("xyz"), atol=1e-6)
    pose = rs.uniform(-0.5, 0.5, size=(5, 7)).astype(np.float32)
    pose[:, 6] = rs.uniform(0, 1, size=5)
    act = rs.uniform(-0.1, 0.1, size=(5, 7)).astype(np.float32)
    new = trot.compose_pose(torch.from_numpy(pose), torch.from_numpy(act)).numpy()
    np.testing.assert_allclose(
        new, np.asarray(jrot.compose_pose(jnp.asarray(pose), jnp.asarray(act))), atol=1e-6)
    diff = trot.pose_diff(torch.from_numpy(pose), torch.from_numpy(new)).numpy()
    np.testing.assert_allclose(
        diff, np.asarray(jrot.pose_diff(jnp.asarray(pose), jnp.asarray(new))), atol=1e-6)


def test_pose_diff_inverts_compose_pose():
    rs = np.random.RandomState(3)
    start = rs.uniform(-0.3, 0.3, size=(4, 7)).astype(np.float32)
    end = rs.uniform(-0.3, 0.3, size=(4, 7)).astype(np.float32)
    start[:, 6], end[:, 6] = 0.4, 0.7
    start, end = torch.from_numpy(start), torch.from_numpy(end)
    recovered = trot.compose_pose(start, trot.pose_diff(start, end))
    np.testing.assert_allclose(recovered.numpy(), end.numpy(), atol=1e-5)


# -- the CEM over a linear world model ----------------------------------------

N, D = 4, 8


def _linear_step_jax(kind):
    def step_fn(params, reps, actions, poses):
        last = reps[:, -N:]
        if kind == "constant":  # every candidate lands on the same latent
            return last
        delta = actions[:, -1, :3]
        if kind == "sign":  # a few distinct distances, each shared by many candidates
            delta = jnp.sign(delta) * 0.05
        return last + jnp.pad(delta, ((0, 0), (0, D - 3)))[:, None, :]

    return step_fn


def _linear_step_torch(kind):
    def step_fn(reps, actions, poses):
        last = reps[:, -N:]
        if kind == "constant":
            return last
        delta = actions[:, -1, :3]
        if kind == "sign":
            delta = torch.sign(delta) * 0.05
        return last + torch.nn.functional.pad(delta, (0, D - 3))[:, None, :]

    return step_fn


def _cem_pair(kind, rollout, seed, samples=64, topk=8, cem_steps=8):
    """(JAX's plan, the port's plan, the draws) of the linear world model
    ``kind`` from one seed's inputs and JAX's draws."""
    kw = dict(rollout=rollout, cem_steps=cem_steps, samples=samples, topk=topk)
    rs = np.random.RandomState(seed)
    rep = rs.randn(N, D).astype(np.float32) * 0.1
    goal = rep.copy()
    goal[:, :3] += rs.uniform(-0.08, 0.08, size=3).astype(np.float32)
    pose = rs.uniform(-0.3, 0.3, size=7).astype(np.float32)
    want = np.asarray(jcem.make_cem(_linear_step_jax(kind), jcem.CEMConfig(**kw))(
        {}, jax.random.PRNGKey(seed), jnp.asarray(rep), jnp.asarray(pose), jnp.asarray(goal)))
    draws = _jax_draws(seed, jcem.CEMConfig(**kw))
    got = tcem.make_cem(_linear_step_torch(kind), tcem.CEMConfig(**kw))(
        torch.from_numpy(rep), pose, torch.from_numpy(goal), sampler=_sampler(draws)).numpy()
    return want, got, draws


@pytest.mark.parametrize("rollout", [1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cem_matches_jax(rollout, seed):
    want, got, _ = _cem_pair("linear", rollout, seed)
    assert got.shape == (rollout, 7) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (got[:, 3:6] == 0).all()


@pytest.mark.parametrize("kind", ["sign", "constant"])
def test_cem_ties_keep_lax_top_k_order(kind):
    """Many candidates share a distance: among equal distances JAX's
    ``lax.top_k`` takes the lower index first, and so must the port's
    stable sort. With "constant" every distance is equal, so the top-k are
    the first k candidates, and the first step's mean is theirs."""
    want, got, draws = _cem_pair(kind, 2, seed=4, cem_steps=3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if kind == "constant":
        one = tcem.make_cem(_linear_step_torch(kind), tcem.CEMConfig(cem_steps=1, samples=64,
                                                                     topk=8))
        plan = one(torch.zeros(N, D), np.zeros(7, np.float32), torch.zeros(N, D),
                   sampler=_sampler(draws)).numpy()
        a4 = draws[0, :, :8] * np.array([0.05, 0.05, 0.05, 1.0], np.float32)
        a4[..., :3] = a4[..., :3].clip(-0.05, 0.05)
        a4[..., 3] = a4[..., 3].clip(-0.75, 0.75)
        mean = a4.mean(axis=1) * 0.85
        np.testing.assert_allclose(plan[:, :3], mean[:, :3], atol=1e-6)


def test_cem_default_noise_is_a_seeded_generator():
    """With no generator the CEM draws from one seeded 0, never the global
    RNG: the plan is the same whatever the global seed, and another seed's
    generator gives another plan."""
    cem = tcem.make_cem(_linear_step_torch("linear"), tcem.CEMConfig(samples=32, topk=4))
    rep, goal = torch.zeros(N, D), torch.full((N, D), 0.02)
    pose = np.zeros(7, np.float32)
    torch.manual_seed(1)
    a = cem(rep, pose, goal).numpy()
    torch.manual_seed(2)
    b = cem(rep, pose, goal).numpy()
    c = cem(rep, pose, goal, generator=torch.Generator().manual_seed(0)).numpy()
    d = cem(rep, pose, goal, generator=torch.Generator().manual_seed(5)).numpy()
    assert np.array_equal(a, b) and np.array_equal(a, c) and not np.array_equal(a, d)


# -- the world model ---------------------------------------------------------

S, E, P, H = 32, 192, 128, 2  # 2 x 2 patches a frame; predictor heads of 64 (DN route)
TPF = (S // 16) ** 2
WM_CEM = dict(rollout=2, cem_steps=3, samples=16, topk=4)
# the plan's seed, picked by scanning seeds 0-11: 7 is the first at which
# every CEM step's k-th and (k+1)-th distances lie further apart than twice
# what the step_fn tolerance lets a distance move (1.5-1.9 times that), so
# no rounding within tolerance can change a top-k set (asserted in the test).
# At the others a late step's gap is 0.01-0.8 times that: the candidates'
# distances close up as the CEM converges.
WM_SEED = 7


def _numpy_params(params, seed):
    """A flax tree with every leaf redrawn from numpy: kernels ~ N(0, 1/fan_in),
    biases ~ N(0, 0.1^2), LayerNorm scales 1 + N(0, 0.1^2). Wider than the
    init's 0.02 so that the actions move the predicted latents."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        if name == "kernel":
            x = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * rs.randn(*shape)
        else:
            x = 0.1 * rs.randn(*shape)
        return jnp.asarray(x, jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.fixture(scope="module")
def world_models():
    """(JAX's WorldModel, the port's, the modules' JAX pair): a depth-2
    encoder of vit_tiny's width (3 heads of 64) at 32 px over 2 frames and a
    depth-2 AC predictor, 128 wide, 2 heads; weights drawn with numpy and
    carried across by `load_world_model_state`."""
    jenc = JaxViT(img_size=(S, S), patch_size=16, num_frames=2, tubelet_size=2, embed_dim=E,
                  depth=2, num_heads=3, use_rope=True)
    jpred = JaxACPredictor(img_size=(S, S), patch_size=16, num_frames=2, tubelet_size=2,
                           embed_dim=E, predictor_embed_dim=P, depth=2, num_heads=H)
    enc_params = _numpy_params(jax.jit(jenc.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, S, S, 3)))["params"], 0)
    zeros = jnp.zeros((1, 1, 7))
    pred_params = _numpy_params(jax.jit(jpred.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, TPF, E)), zeros, zeros)["params"], 1)
    jwm = JaxWorldModel(jenc, enc_params, jpred, pred_params, tokens_per_frame=TPF,
                        cem_config=jcem.CEMConfig(**WM_CEM))
    enc = VisionTransformer(img_size=(S, S), patch_size=16, num_frames=2, tubelet_size=2,
                            embed_dim=E, depth=2, num_heads=3, use_rope=True, use_flash=True)
    pred = vit_ac_predictor(img_size=(S, S), patch_size=16, embed_dim=E, predictor_embed_dim=P,
                            depth=2, num_heads=H, use_flash=True)
    wm = load_world_model_state(
        WorldModel(enc, pred, TPF, cem_config=tcem.CEMConfig(**WM_CEM)), enc_params,
        pred_params)
    return jwm, wm, (jpred, pred_params)


def _frames(seed):
    rs = np.random.RandomState(seed)
    return [rs.rand(S, S, 3).astype(np.float32) for _ in range(2)]


def test_world_model_encode_matches_jax(world_models):
    jwm, wm, _ = world_models
    for frame in _frames(10):
        want = np.asarray(jwm.encode(frame))
        got = wm.encode(frame)
        assert got.shape == (TPF, E) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("T", [1, 2])
def test_world_model_step_fn_matches_jax(world_models, T):
    """JAX's step_fn (`world_model.py:44-50`: the predictor, its last frame,
    `feature_layernorm`) against the port's, on 3 candidates of T frames."""
    jwm, wm, (jpred, pred_params) = world_models
    rs = np.random.RandomState(20 + T)
    reps = rs.randn(3, T * TPF, E).astype(np.float32)
    actions = rs.uniform(-0.1, 0.1, size=(3, T, 7)).astype(np.float32)
    poses = rs.uniform(-0.5, 0.5, size=(3, T, 7)).astype(np.float32)
    nxt = jpred.apply({"params": pred_params}, jnp.asarray(reps), jnp.asarray(actions),
                      jnp.asarray(poses))[:, -TPF:]
    want = np.asarray(jax_feature_layernorm(nxt))
    with torch.inference_mode():
        got = wm.step_fn(torch.from_numpy(reps), torch.from_numpy(actions),
                         torch.from_numpy(poses))
    assert got.shape == (3, TPF, E)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_world_model_plan_matches_jax(world_models):
    _plan_matches_jax(world_models)


def test_world_model_plan_matches_jax_on_the_bhnd_route(world_models, monkeypatch):
    """The plan on the BHND route, which heads wider than 64 take on the card
    (at bf16 and fp32; heads of 16-64 take the DN route at both): the
    encoder's and the AC predictor's attention on the BHND kernels' plain
    versions (the frame-causal ids and pad keys of the stack-padded AC
    sequence), none on the DN route."""
    def refused(*args, **kwargs):
        raise AssertionError("the DN route ran")

    monkeypatch.setattr(modules, "dn_head_eligible", lambda d: False)
    monkeypatch.setattr(modules, "attend_bhdn", refused)
    _plan_matches_jax(world_models)


def _plan_matches_jax(world_models):
    jwm, wm, _ = world_models
    start, goal_frame = _frames(WM_SEED)
    rep, goal = wm.encode(start), wm.encode(goal_frame)
    pose = np.random.RandomState(WM_SEED).uniform(-0.3, 0.3, size=7).astype(np.float32)
    cfg = wm.cem_config
    draws = _jax_draws(WM_SEED, cfg)

    # every step's distances, from the port's step_fn on the final frame
    dists = []

    def recording(reps, actions, poses):
        out = wm.step_fn(reps, actions, poses)
        if actions.shape[1] == cfg.rollout:
            dists.append((out - goal[None]).abs().mean(dim=(1, 2)))
            bound.append(ATOL + RTOL * out.abs().mean().item())
        return out

    bound = []
    plan = tcem.make_cem(recording, cfg)(rep, pose, goal, sampler=_sampler(draws)).numpy()
    assert len(dists) == cfg.cem_steps
    for step, (d, b) in enumerate(zip(dists, bound)):
        ranked = torch.sort(d).values
        gap = (ranked[cfg.topk] - ranked[cfg.topk - 1]).item()
        # a distance is a mean of |out - goal| over the latent, so an out within
        # atol + rtol |out| moves it by at most b = atol + rtol mean|out|
        assert gap > 2 * b, f"step {step}: top-k margin {gap} within 2 x {b}"

    got = wm.infer_next_action(rep, pose, goal, sampler=_sampler(draws))
    np.testing.assert_array_equal(got, plan)
    want = np.asarray(jwm.infer_next_action(jnp.asarray(rep.numpy()), pose,
                                            jnp.asarray(goal.numpy()),
                                            rng=jax.random.PRNGKey(WM_SEED)))
    assert got.shape == (cfg.rollout, 7)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
