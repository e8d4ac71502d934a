"""Reference ``.pth`` checkpoints into the port against the JAX converter.

The state dicts come from the torch-only reference doubles in
tests/fake_reference (the upstream key layout: ``backbone.layer1.0``,
``feature_pyramid.inner_blocks.N``, per-level copies of tied modules,
``nn.MultiheadAttention``'s packed ``in_proj_weight``, ...) with seeded
weights, saved as the reference trainer saves them (``{"weight": ...}``
with DDP prefixes).  Each file goes through JAX's ``eval/main.py::
load_params`` with ``convert_act3d`` / ``convert_diffusion_planner`` and
through the port's ``load_params`` with ``act3d_from_reference`` /
``diffusion_planner_from_reference``; the two models then run the same
inputs with injected ghost points and diffusion noise; so do untied Act3D
levels and multi-round / multi-scale planner heads, and both packages
refuse a ResNet-trunk ``.pth``.  Tolerance 1e-3,
the full-model bound of tests/README.md; Act3D positions must agree
exactly, which the test makes safe by asserting every level's top-2 mask
margin.  Small widths: 64^2 images, 2 cameras, emb 12 / 24, 2 levels.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from act3d_tpu.convert.torch_to_jax import convert_act3d, convert_diffusion_planner
from act3d_tpu.eval.main import load_params as jax_load_params
from act3d_tpu.models import Act3D as JAct3D
from act3d_tpu.models import DiffusionPlanner as JDiffusionPlanner
from act3d_tpu.models import compute_trajectory as jax_compute_trajectory
from act3d_tpu_torch.convert import act3d_from_reference, diffusion_planner_from_reference
from act3d_tpu_torch.eval.main import load_params
from act3d_tpu_torch.models import Act3D, DiffusionPlanner, compute_trajectory

from tests.torch_parity import close, fake_reference_models, random_params
from tests.torch_parity import save_reference_checkpoint, t
from tests.test_torch_options import _assert_margins, _assert_nn_margins

TOL = 1e-3
BOUNDS = ((-0.3, -0.5, 0.75), (0.7, 0.5, 1.5))
NCAM, IMAGE, N_INSTR, LENGTH, STEPS, LEVELS = 2, 64, 7, 6, 3, 2
ACT3D_CFG = dict(image_size=(IMAGE, IMAGE), embedding_dim=12, num_sampling_level=LEVELS,
                 num_ghost_points_val=20, use_instruction=True, gripper_loc_bounds=BOUNDS)
PLANNER_CFG = dict(image_size=(IMAGE, IMAGE), embedding_dim=24, num_query_cross_attn_layers=3,
                   use_instruction=True, use_goal=True, use_goal_at_test=False,
                   diffusion_timesteps=STEPS, gripper_loc_bounds=BOUNDS)
CONVERT_PLANNER = dict(num_query_cross_attn_layers=3, num_vis_ins_attn_layers=2)


def _observation(seed):
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(BOUNDS, np.float32)
    rgb = rng.uniform(0, 1, (1, NCAM, 3, IMAGE, IMAGE)).astype(np.float32)
    pcd = rng.uniform(lo, hi, (1, NCAM, IMAGE, IMAGE, 3)).astype(np.float32)
    pcd = np.ascontiguousarray(pcd.transpose(0, 1, 4, 2, 3))
    instr = rng.normal(size=(1, N_INSTR, 512)).astype(np.float32)
    quat = rng.normal(size=4)
    gripper = np.concatenate([rng.uniform(lo, hi), quat / np.linalg.norm(quat), [1.0]])
    ghosts = [rng.uniform(lo, hi, (1, 10, 3)).astype(np.float32) for _ in range(LEVELS)]
    return rgb, pcd, instr, gripper[None].astype(np.float32), ghosts


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Reference-layout .pth files of both models and their state dicts."""
    ref_act3d, ref_planner = fake_reference_models()
    root = tmp_path_factory.mktemp("reference")
    torch.manual_seed(0)
    act3d = ref_act3d(**ACT3D_CFG)
    planner = ref_planner(**{k: v for k, v in PLANNER_CFG.items() if k != "use_goal_at_test"})
    return {
        name: (root / f"{name}.pth", save_reference_checkpoint(model, root / f"{name}.pth", seed))
        for seed, (name, model) in enumerate((("act3d", act3d), ("planner", planner)))
    }


def test_act3d_reference_checkpoint_matches_jax(checkpoints):
    path, _ = checkpoints["act3d"]
    rgb, pcd, instr, gripper, ghosts = _observation(1)
    jm = JAct3D(**ACT3D_CFG)
    template = random_params(jm, 0, rgb, pcd, instr, gripper,
                             sample_rng=jax.random.PRNGKey(0), train_mode=False)
    params = jax_load_params(path, jm, lambda: {"params": template},
                             lambda sd, tpl: convert_act3d(sd, tpl, num_sampling_level=LEVELS))
    port = load_params(path, Act3D(**ACT3D_CFG, device="cpu"),
                       lambda sd: act3d_from_reference(sd, num_sampling_level=LEVELS)).eval()

    want = jax.jit(lambda p, ghosts: jm.apply(
        {"params": p}, rgb, pcd, instr, gripper, sample_rng=jax.random.PRNGKey(0),
        train_mode=False, ghost_points_override=ghosts))(params, [jnp.asarray(g) for g in ghosts])
    with torch.no_grad():
        got = port(t(rgb), t(pcd), t(instr), t(gripper),
                   ghost_points_override=[t(g) for g in ghosts])
    _assert_margins(got["ghost_pcd_masks_pyramid"], want["ghost_pcd_masks_pyramid"])
    for g_level, w_level in zip(got["ghost_pcd_masks_pyramid"], want["ghost_pcd_masks_pyramid"]):
        for g, w in zip(g_level, w_level):
            close(g, w, TOL, TOL)
    close(got["position"], want["position"], 0)
    close(got["rotation"], want["rotation"], TOL)
    close(got["gripper"], want["gripper"], TOL)


def test_planner_reference_checkpoint_matches_jax(checkpoints):
    path, _ = checkpoints["planner"]
    rgb, pcd, instr, gripper, _ = _observation(2)
    curr, goal = gripper[:, :7], gripper[:, :7] + np.float32(0.05)
    mask = np.zeros((1, LENGTH), bool)
    mask[0, -2:] = True
    jm = JDiffusionPlanner(**PLANNER_CFG)
    template = random_params(jm, 0, np.zeros((1, LENGTH, 7), np.float32), mask, rgb, pcd,
                             instr, curr, curr, noise_rng=jax.random.PRNGKey(0))
    params = jax_load_params(
        path, jm, lambda: {"params": template},
        lambda sd, tpl: convert_diffusion_planner(sd, tpl, **CONVERT_PLANNER))
    port = load_params(path, DiffusionPlanner(**PLANNER_CFG, device="cpu"),
                       lambda sd: diffusion_planner_from_reference(sd, **CONVERT_PLANNER)).eval()

    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda p: jax_compute_trajectory(jm, {"params": p}, mask, rgb, pcd, instr,
                                                    curr, goal, key))(params)
    k_init, k_steps = jax.random.split(key)
    noise = (t(jax.random.normal(k_init, (1, LENGTH, 9), dtype=jnp.float32)),
             t(jnp.stack([jax.random.normal(k, (1, LENGTH, 9), dtype=jnp.float32)
                          for k in jax.random.split(k_steps, STEPS)])))
    with torch.no_grad():
        got = compute_trajectory(port, t(mask), t(rgb), t(pcd), t(instr), t(curr), t(goal),
                                 noise=noise)
    assert got.shape == (1, LENGTH, 7)
    close(got, want, TOL, TOL)


def _edit(state, case):
    state = dict(state)
    if case == "extra":
        state["module.unexpected.weight"] = torch.zeros(3)
    elif case == "missing":
        del state[next(k for k in state if k.endswith("curr_gripper_embed.weight"))]
    elif case == "untied":
        key = next(k for k in state if k.startswith("module.query_cross_attn_pyramid.1."))
        state[key] = state[key] + 1.0
    return state


@pytest.mark.parametrize("name,case,error,match", [
    ("act3d", "extra", KeyError, "unused .*unexpected.weight"),
    ("act3d", "missing", KeyError, "missing .*curr_gripper_embed.weight"),
    ("act3d", "untied", ValueError, "not tied"),
    ("planner", "extra", KeyError, "unused .*unexpected.weight"),
    ("planner", "missing", KeyError, "missing .*curr_gripper_embed.weight"),
])
def test_reference_state_dict_must_match_the_port(checkpoints, name, case, error, match):
    _, state = checkpoints[name]
    convert = {
        "act3d": lambda sd: act3d_from_reference(sd, num_sampling_level=LEVELS),
        "planner": lambda sd: diffusion_planner_from_reference(sd, **CONVERT_PLANNER),
    }[name]
    model = {"act3d": lambda: Act3D(**ACT3D_CFG, device="cpu"),
             "planner": lambda: DiffusionPlanner(**PLANNER_CFG, device="cpu")}[name]()
    model.load_state_dict(convert(state), strict=True)  # the file as saved loads
    with pytest.raises(error, match=match):
        convert(_edit(state, case))


def _multi_block_state(state, n_blocks, seed):
    """A reference planner state dict with ``n_blocks`` blocks from a
    one-block one: every per-block ``ModuleList`` entry of block 0 copied to
    blocks 1.. with seeded perturbations (the fake reference builds one
    block only)."""
    gen = torch.Generator().manual_seed(seed)
    lists = ("vl_attention", "traj_lang_attention", "traj_attention", "pos_attention",
             "rot_attention", "pos_regressor", "rot_regressor")
    out = dict(state)
    for key, value in state.items():
        for name in lists:
            block0 = f"module.prediction_head.{name}.0."
            if key.startswith(block0):
                for i in range(1, n_blocks):
                    noise = 0.05 * torch.randn(value.shape, generator=gen)
                    out[f"module.prediction_head.{name}.{i}.{key[len(block0):]}"] = value + noise
    return out


@pytest.mark.parametrize("model,options", [
    ("act3d", dict(weight_tying=False)),
    ("act3d", dict(gp_emb_tying=False)),
    ("planner", dict(attn_rounds=2)),
    ("planner", dict(feat_scales=3)),
], ids=["weight_tying", "gp_emb_tying", "attn_rounds", "feat_scales"])
def test_unported_reference_configurations_raise(tmp_path, model, options):
    """The reference configurations the port once refused: untied Act3D
    levels (the fake reference builds them) and multi-round / multi-scale
    heads (blocks added to a one-block state dict), converted by both
    packages, run the same inputs to the same outputs (1e-3)."""
    if model == "act3d":
        _untied_act3d_matches_jax(tmp_path, options)
    else:
        _multi_block_planner_matches_jax(tmp_path, options)


def _untied_act3d_matches_jax(tmp_path, options):
    ref_act3d, _ = fake_reference_models()
    torch.manual_seed(0)
    path = tmp_path / "act3d.pth"
    state = save_reference_checkpoint(ref_act3d(**ACT3D_CFG, **options), path, 3)
    assert any(k.startswith("module.ghost_points_embed_pyramid.1")
               or k.startswith("module.query_cross_attn_pyramid.1") for k in state)
    cfg = dict(ACT3D_CFG, **options)
    rgb, pcd, instr, gripper, ghosts = _observation(5)
    jm = JAct3D(**cfg)
    template = random_params(jm, 0, rgb, pcd, instr, gripper,
                             sample_rng=jax.random.PRNGKey(0), train_mode=False)
    params = jax_load_params(path, jm, lambda: {"params": template},
                             lambda sd, tpl: convert_act3d(sd, tpl, num_sampling_level=LEVELS,
                                                           **options))
    port = load_params(path, Act3D(**cfg, device="cpu"),
                       lambda sd: act3d_from_reference(sd, num_sampling_level=LEVELS,
                                                       **options)).eval()
    want = jax.jit(lambda p, ghosts: jm.apply(
        {"params": p}, rgb, pcd, instr, gripper, sample_rng=jax.random.PRNGKey(0),
        train_mode=False, ghost_points_override=ghosts))(params, [jnp.asarray(g) for g in ghosts])
    with torch.no_grad():
        got = port(t(rgb), t(pcd), t(instr), t(gripper),
                   ghost_points_override=[t(g) for g in ghosts])
    _assert_margins(got["ghost_pcd_masks_pyramid"], want["ghost_pcd_masks_pyramid"])
    for g_level, w_level in zip(got["ghost_pcd_masks_pyramid"], want["ghost_pcd_masks_pyramid"]):
        for g, w in zip(g_level, w_level):
            close(g, w, TOL, TOL)
    close(got["position"], want["position"], 0)
    close(got["rotation"], want["rotation"], TOL)


def _multi_block_planner_matches_jax(tmp_path, options):

    _, ref_planner = fake_reference_models()
    torch.manual_seed(0)
    state = save_reference_checkpoint(
        ref_planner(**{k: v for k, v in PLANNER_CFG.items() if k != "use_goal_at_test"}),
        tmp_path / "one_block.pth", 4)
    rounds, scales = options.get("attn_rounds", 1), options.get("feat_scales", 1)
    path = tmp_path / "planner.pth"
    torch.save({"weight": _multi_block_state(state, rounds * scales, 5)}, path)
    cfg = dict(PLANNER_CFG, attn_rounds=rounds, feat_scales_to_use=scales)
    rgb, pcd, instr, gripper, _ = _observation(6)
    curr, goal = gripper[:, :7], gripper[:, :7] + np.float32(0.05)
    mask = np.zeros((1, LENGTH), bool)
    mask[0, -2:] = True
    jm = JDiffusionPlanner(**cfg)
    template = random_params(jm, 0, np.zeros((1, LENGTH, 7), np.float32), mask, rgb, pcd,
                             instr, curr, curr, noise_rng=jax.random.PRNGKey(0))
    convert = dict(CONVERT_PLANNER, **options)
    params = jax_load_params(path, jm, lambda: {"params": template},
                             lambda sd, tpl: convert_diffusion_planner(sd, tpl, **convert))
    port = load_params(path, DiffusionPlanner(**cfg, device="cpu"),
                       lambda sd: diffusion_planner_from_reference(sd, **convert)).eval()
    traj = np.random.default_rng(7).normal(size=(1, LENGTH, 9)).astype(np.float32) * 0.3

    @jax.jit
    def jax_side(p):
        context, _, _ = jm.apply({"params": p}, rgb, pcd, instr, curr, goal,
                                 method=JDiffusionPlanner.encode)
        blocks = jm.apply({"params": p}, traj, mask, jnp.asarray([1]), context,
                          method=lambda m, *a: m.head.denoise(*a))
        return blocks, context["pcd_pyramid"]

    want, pcd_pyramid = jax_side(params)
    assert len(want) == rounds * scales
    _assert_nn_margins(cfg, want, pcd_pyramid)
    with torch.no_grad():
        context, _, _ = port.encode(t(rgb), t(pcd), t(instr), t(curr), t(goal))
        got = port.prediction_head.denoise(t(traj), t(mask), torch.tensor([1]), context)
    for g, w in zip(got, want):
        close(g, w, TOL, TOL)


def _torchvision_resnet_trunk(prefix):
    """The key layout of a torchvision ResNet-50 trunk under ``prefix``,
    seeded values: the port's TorchResNet50 renamed."""
    from act3d_tpu_torch.nn.resnet import TorchResNet50

    torch.manual_seed(1)
    out = {}
    for key, value in TorchResNet50().state_dict().items():
        head, _, rest = key.partition(".")
        if head.startswith("layer"):
            li, bi = head[len("layer"):].split("_")
            rest = rest.replace("downsample_conv", "downsample.0").replace(
                "downsample_bn", "downsample.1")
            key = f"layer{li}.{bi}.{rest}"
        out[f"{prefix}{key}"] = value
    return out


def test_resnet_trunk_reference_checkpoints_are_refused_by_both(checkpoints, tmp_path):
    """JAX's converter maps the CLIP trunk only (convert/torch_to_jax.py
    clip_backbone), so an Act3D .pth with a torchvision ResNet-50 trunk is
    refused by JAX's load path and by the port's, both with KeyError naming
    a CLIP stem key the file lacks."""
    _, state = checkpoints["act3d"]
    state = {k: v for k, v in state.items() if not k.startswith("module.backbone.")}
    state.update(_torchvision_resnet_trunk("module.backbone."))
    path = tmp_path / "resnet_act3d.pth"
    torch.save({"weight": state}, path)
    cfg = dict(ACT3D_CFG, backbone="resnet")
    rgb, pcd, instr, gripper, _ = _observation(1)
    jm = JAct3D(**cfg)
    template = random_params(jm, 0, rgb, pcd, instr, gripper,
                             sample_rng=jax.random.PRNGKey(0), train_mode=False)
    with pytest.raises(KeyError, match="backbone.conv2.weight"):
        jax_load_params(path, jm, lambda: {"params": template},
                        lambda sd, tpl: convert_act3d(sd, tpl, num_sampling_level=LEVELS))
    with pytest.raises(KeyError, match="backbone.conv2.weight"):
        load_params(path, Act3D(**cfg, device="cpu"),
                    lambda sd: act3d_from_reference(sd, num_sampling_level=LEVELS))
