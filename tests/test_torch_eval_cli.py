"""The port's eval CLI (``act3d_tpu_torch.eval.main``) on the CPU over the
sim-free backend, against JAX's ``act3d_tpu.eval.main``.

Small size: one camera at 128^2, Act3D emb 12 over 2 levels, planner emb 24
with 3 query layers and 2 diffusion steps.  With ``--offline 1
--predict_traj 0`` the loop follows the demos' keyposes, so no random
draw reaches the score: both CLIs, given the same reference-layout
``.pth`` files (JAX's CLI reads ``.pth`` or ``.msgpack``, not the port's
``.pt``), must write the same rates and the same JSON.  The chained path
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
    with pytest.MonkeyPatch.context() as patch:
        for cls in (jax_main.Act3D, jax_main.DiffusionPlanner):
            patch.setattr(cls, "init", _shape_only_init)
        jax_results = jax_main.main(_argv(root, root / "act3d.pth", root / "planner.pth",
                                          "jax.json", *offline))
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
    root, _, _ = tree
    with pytest.raises(NotImplementedError, match=".msgpack"):
        port_main.main(_argv(root, root / "act3d.msgpack", root / "planner" / "best.pt",
                             "msgpack.json", "--device", "cpu"))


def test_cli_without_a_card_raises_instead_of_using_the_cpu(tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root, _, _ = tree
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main(_argv(root, root / "act3d.pth", root / "planner.pth", "card.json"))
    assert not (root / "card.json").exists()
