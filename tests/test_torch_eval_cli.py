"""The port's eval CLI (``act3d_tpu_torch.eval.main``) on the CPU over the
sim-free backend, against JAX's ``act3d_tpu.eval.main``.

Small size: one camera at 128^2, Act3D emb 12 over 2 levels, planner emb 24
with 3 query layers and 2 diffusion steps.  With ``--offline 1
--predict_traj 0`` the loop follows the demos' keyposes, so no random
draw reaches the score: both CLIs, given the same reference-layout
``.pth`` files (JAX's CLI reads ``.pth`` or ``.msgpack``, not the port's
``.pt``), must write the same rates and the same JSON, and so must the
port's CLI over the ``.msgpack`` files JAX's Trainer writes of the same
weights.  The chained path
(Act3D keypose -> goal -> sampler) runs over ``.pt`` checkpoints written
by the port's Trainer.

JAX's ``build_models`` initialises both flax models eagerly only to get a
template of their shapes, whose every leaf the ``.pth`` then replaces;
here ``init`` returns zeros of ``jax.eval_shape``'s shapes instead, which
spares the CPU some 800 single-op compiles.
"""

import json
import pickle

import numpy as np
import pytest
import torch

import jax

from act3d_tpu.eval import main as jax_main
from act3d_tpu_torch.data.fixtures import make_instructions
from act3d_tpu_torch.eval import main as port_main
from act3d_tpu_torch.models import Act3D, DiffusionPlanner
from act3d_tpu_torch.train.engine import Trainer

from tests.torch_parity import fake_reference_models, save_reference_checkpoint

TASK = "pick_and_lift"
WIDTHS = ["--image_size", "128,128", "--cameras", "left_shoulder",
          "--keypose_embedding_dim", "12", "--traj_embedding_dim", "24",
          "--num_ghost_points", "12", "--num_ghost_points_val", "24",
          "--num_sampling_level", "2", "--num_query_cross_attn_layers", "3",
          "--diffusion_timesteps", "2", "--interpolation_length", "6"]
ACT3D_CFG = dict(image_size=(128, 128), embedding_dim=12, num_ghost_points=12,
                 num_ghost_points_val=24, num_sampling_level=2, use_instruction=True)
PLANNER_CFG = dict(image_size=(128, 128), embedding_dim=24, num_query_cross_attn_layers=3,
                   use_instruction=True, use_goal=True, diffusion_timesteps=2)


def _argv(root, keypose, traj, output, *extra):
    return ["--data_dir", str(root), "--tasks", TASK, "--instructions", str(root / "I.pkl"),
            "--keypose_ckpt", str(keypose), "--traj_ckpt", str(traj),
            "--num_demos", "1", "--max_steps", "3", "--fake_sim", "1",
            "--log_dir", str(root / "logs"), "--output", str(root / output), *WIDTHS, *extra]


def _layout(results):
    return {task: sorted(str(k) for k in rates) for task, rates in results.items()}


_FLAX_INIT = jax_main.Act3D.init  # flax.linen.Module.init, which both models inherit


def _shape_only_init(self, *args, **kwargs):
    shapes = jax.eval_shape(lambda: _FLAX_INIT(self, *args, **kwargs))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Instructions, reference .pth and port .pt checkpoints of both models,
    and JAX's CLI run offline over the .pth files."""
    root = tmp_path_factory.mktemp("eval_cli")
    (root / "I.pkl").write_bytes(pickle.dumps(make_instructions((TASK,), seed=0)))
    ref_act3d, ref_planner = fake_reference_models()
    torch.manual_seed(0)
    save_reference_checkpoint(ref_act3d(**ACT3D_CFG), root / "act3d.pth", 0)
    save_reference_checkpoint(ref_planner(**PLANNER_CFG), root / "planner.pth", 1)
    for name, model in (("act3d", Act3D(**ACT3D_CFG, device="cpu")),
                        ("planner", DiffusionPlanner(**PLANNER_CFG, device="cpu"))):
        Trainer(None, model).save_checkpoint(root / name)
    offline = ["--offline", "1", "--predict_traj", "0"]
    built = []
    build_models = jax_main.build_models
    with pytest.MonkeyPatch.context() as patch:
        for cls in (jax_main.Act3D, jax_main.DiffusionPlanner):
            patch.setattr(cls, "init", _shape_only_init)
        patch.setattr(jax_main, "build_models",
                      lambda *a: built.append(build_models(*a)) or built[-1])
        jax_results = jax_main.main(_argv(root, root / "act3d.pth", root / "planner.pth",
                                          "jax.json", *offline))
    # JAX's Trainer writes the weights JAX's CLI loaded as best.msgpack / last.msgpack
    from act3d_tpu.train.engine import Trainer as JaxTrainer

    (_, keypose_params, _, traj_params), = built
    for name, params in (("act3d", keypose_params), ("planner", traj_params)):
        JaxTrainer(None, params).save_checkpoint(root / f"jax_{name}")
    return root, offline, jax_results


def test_offline_rates_and_json_match_jax(tree):
    root, offline, jax_results = tree
    results = port_main.main(_argv(root, root / "act3d.pth", root / "planner.pth",
                                   "port.json", *offline, "--device", "cpu"))
    assert results == jax_results
    assert results[TASK]["mean"] == 2.0  # the demo's final keypose scores, 2 demos
    assert (root / "port.json").read_text() == (root / "jax.json").read_text()


def test_chained_policy_over_trainer_checkpoints(tree):
    root, _, jax_results = tree
    results = port_main.main(_argv(root, root / "act3d" / "best.pt", root / "planner" / "best.pt",
                                   "chained.json", "--device", "cpu"))
    written = json.loads((root / "chained.json").read_text())
    assert _layout(written) == _layout(json.loads((root / "jax.json").read_text()))
    assert _layout(results) == _layout(jax_results)
    assert all(0.0 <= rate <= 2.0 for rate in written[TASK].values())


def test_msgpack_checkpoints_are_not_ported(tree):
    """``.msgpack`` loading is ported: the best.msgpack files JAX's Trainer
    wrote from the weights JAX's CLI ran (payload params, opt_state, step;
    best_loss None, stripped) load into the port's CLI, which scores them
    as JAX's CLI did, with the same JSON; each model's weights equal the
    same .pth file's through the port.  The reader is held against the
    installed msgpack with flax's extension hook, over the whole payload."""
    import msgpack
    from flax import serialization

    from act3d_tpu_torch.core.msgpack import load_msgpack

    root, offline, jax_results = tree
    keypose, traj = root / "jax_act3d" / "best.msgpack", root / "jax_planner" / "best.msgpack"
    results = port_main.main(_argv(root, keypose, traj, "msgpack.json", *offline,
                                   "--device", "cpu"))
    assert results == jax_results
    assert (root / "msgpack.json").read_text() == (root / "jax.json").read_text()

    for path, model, pth, convert, flax_fn in (
            (keypose, Act3D(**ACT3D_CFG, device="cpu"), root / "act3d.pth",
             lambda sd: port_main.act3d_from_reference(sd, num_sampling_level=2),
             port_main.act3d_from_flax),
            (traj, DiffusionPlanner(**PLANNER_CFG, device="cpu"), root / "planner.pth",
             lambda sd: port_main.diffusion_planner_from_reference(
                 sd, num_query_cross_attn_layers=3), port_main.diffusion_planner_from_flax)):
        from_msgpack = port_main.load_params(path, model, None, flax_fn).state_dict()
        from_pth = port_main.load_params(pth, model, convert).state_dict()
        assert from_msgpack.keys() == from_pth.keys()
        assert all(torch.equal(from_msgpack[k], from_pth[k]) for k in from_pth)

        payload = load_msgpack(path)
        want = msgpack.unpackb(path.read_bytes(), raw=False,
                               ext_hook=serialization._msgpack_ext_unpack)
        assert sorted(payload) == sorted(want) == ["opt_state", "params", "step"]
        assert payload["step"] == want["step"] == 0
        got_leaves = jax.tree_util.tree_leaves_with_path(payload)
        want_leaves = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (_, g), (_, w) in zip(got_leaves, want_leaves):
            assert np.asarray(g).dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, w)


def test_cli_without_a_card_raises_instead_of_using_the_cpu(tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root, _, _ = tree
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main(_argv(root, root / "act3d.pth", root / "planner.pth", "card.json"))
    assert not (root / "card.json").exists()
