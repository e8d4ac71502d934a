"""The benchmark's frozen plain reference against act3d_tpu_torch at test
widths on the CPU: one seeded state dict loaded into both, the same
inputs, the same generator seeds."""

import numpy as np
import pytest
import torch

from benchmark import models
from benchmark.drivers import keystep, train
from benchmark.reference.act3d import keypose_loss
from benchmark.reference.layers import Generators
from tiny import run_tiny, tiny_config, tiny_root

CFG = tiny_config()
TRAFFIC = {"batch": 2, "batch_pool": 2}
_cfg = tiny_config


def test_state_dict_layouts_match():
    for kind in ("act3d", "planner"):
        adapter = models.adapter(CFG, kind)
        prog = adapter.program(CFG, 1, "cpu").state_dict()
        ref = adapter.reference(CFG, 1, "cpu").state_dict()
        assert list(prog) == list(ref)
        for name in prog:
            assert torch.equal(prog[name], ref[name]), name


def test_act3d_eval_forward():
    adapter = models.adapter(CFG, "act3d")
    prog = adapter.program(CFG, 7, "cpu").eval()
    ref = adapter.reference(CFG, 7, "cpu").eval()
    batch = train.make_batches(_cfg("act3d"), TRAFFIC, 7, "cpu")[0]
    gen = torch.Generator().manual_seed(3)
    ghosts = [torch.rand(2, 20, 3, generator=gen) for _ in range(3)]
    args = (batch["rgbs"], batch["pcds"], batch["instr"], batch["curr_gripper"])
    with torch.no_grad():
        got = prog(*args, ghost_points_override=ghosts)
        want = ref(*args, ghost_points=ghosts)
    for key in ("position", "rotation", "gripper"):
        torch.testing.assert_close(got[key], want[key], atol=1e-6, rtol=1e-5)
    for g, w in zip(got["ghost_pcd_masks_pyramid"], want["ghost_pcd_masks_pyramid"]):
        torch.testing.assert_close(g[-1], w[-1], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["act3d", "planner"])
def test_training_loss_and_gradients(kind):
    """The training loss with the step's generator draws (ghost points;
    noise, timesteps and dropout) and every trainable leaf's gradient."""
    from act3d_tpu_torch.nn.dropout import Generators as ProgGenerators

    cfg = _cfg(kind)
    adapter = models.adapter(cfg, kind)
    batch = train.make_batches(cfg, TRAFFIC, 11, "cpu")[0]
    prog = adapter.program(cfg, 11, "cpu").train()
    ref = adapter.reference(cfg, 11, "cpu").train()
    got, _ = adapter.loss_fn(prog)(batch, ProgGenerators.from_seed(5, "cpu"))
    want = adapter.reference_loss(ref, batch, Generators.from_seed(5, "cpu"))[0]
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    got.backward()
    want.backward()
    grads = dict(ref.named_parameters())
    for name, p in prog.named_parameters():
        if p.grad is not None:
            torch.testing.assert_close(p.grad, grads[name].grad, atol=1e-6, rtol=1e-4)


def test_keypose_loss_formula():
    pred = {"ghost_pcd_pyramid": [torch.zeros(1, 2, 3)],
            "ghost_pcd_masks_pyramid": [[torch.tensor([[0.0, 0.0]])]],
            "rotation": torch.tensor([[1.0, 0, 0, 0]]), "gripper": torch.tensor([[1.0]])}
    gt = torch.tensor([[0.0, 0, 0, 0, 1, 0, 0, 0]])
    # CE of uniform scores against equal labels = log 2; rotation MSE 0.5 x 10; gripper 1
    assert float(keypose_loss(pred, gt)) == pytest.approx(np.log(2) + 5.0 + 1.0, rel=1e-6)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", ["tiny.keystep", "tiny.train"])
def test_cell_check_reads_rounding_only(tmp_path, workload, trace):
    """The whole run on the CPU, with and without the traced stretch after
    the window: the check's readings of the sound system lie at float32
    rounding, and a traced run reads mfu from the untraced window."""
    rc, result = run_tiny(tiny_root(tmp_path), workload, trace=trace)
    assert rc == 0 and result["correct"], result
    for name, reading in result["checks"].items():
        if name != "change_gap":
            assert reading["value"] < 1e-5, (name, reading)
    if trace:
        kind = workload.split(".")[1]
        assert result["metrics"][f"mfu.{kind}"]["value"] > 0, result["metrics"]


def test_the_systems_choices_are_followed_and_judged():
    """The reference follows the ghost points the system chose at every
    level and reads how far below its best their scores lie; on its own
    choices it reads 0."""
    cfg = _cfg("planner")
    tr = {"observation_pool": 1, "instruction_bank": 1, "input_sets": 1, "episode_keysteps": 1}
    inputs = keystep.Inputs(cfg, tr, 5, "cpu")
    ref_a, ref_p = keystep.references(cfg, 5, "cpu")
    own, chosen, gap = keystep.reference_keystep(ref_a, ref_p, inputs, 0)
    assert gap == 0.0
    again, _, gap = keystep.reference_keystep(ref_a, ref_p, inputs, 0, chosen)
    assert gap == 0.0
    np.testing.assert_array_equal(again["trajectory"], own["trajectory"])
    # the system chose another fine ghost point: followed, and judged below the best
    fine = inputs.ghosts[0][-1][0]
    other = next(p for p in fine if not torch.equal(p, chosen[-1][0]))
    moved, followed, gap = keystep.reference_keystep(ref_a, ref_p, inputs, 0,
                                                     chosen[:-1] + [other[None]])
    torch.testing.assert_close(followed[-1][0], other, rtol=0, atol=0)
    np.testing.assert_array_equal(moved["action"][0, :3], other.numpy())
    assert gap > 0.0
