"""The multi-scale planner head's trajectory-nearest selection, its spans
and its counters (``models/diffusion_head.py``), at a tiny 3-scale x
2-round head on the CPU.

The selection runs through the parameter-free submodule ``traj_neighbours``:
a forward hook on it sees exactly the indices the head gathers, four per
``denoise`` (scales 1 and 2 of both rounds); ``find_traj_nn.calls`` and
``DiffusionHead.evaluations`` step by 4 and 1; a profiler trace holds
``planner.knn`` four times and each ``planner.block.scale{n}`` twice per
``denoise``; the submodule adds no state-dict entry, and a one-scale head
builds none, selects nothing and opens none of these spans.
"""

from collections import Counter

import pytest
import torch

from act3d_tpu_torch.models import DiffusionHead, DiffusionPlanner
from act3d_tpu_torch.models.diffusion_head import TrajectoryNeighbours
from act3d_tpu_torch.ops.geometry import find_traj_nn
from act3d_tpu_torch.utils.testing import BOUNDS, synthetic_trajectory_batch

SCALES, ROUNDS, LENGTH, IMAGE = 3, 2, 8, 64
SELECTING = [i for i in range(SCALES * ROUNDS) if i % SCALES > 0]  # blocks 1, 2, 4, 5


def _planner(scales=SCALES, rounds=ROUNDS):
    torch.manual_seed(0)
    return DiffusionPlanner(image_size=(IMAGE, IMAGE), embedding_dim=24,
                            num_query_cross_attn_layers=3, num_vis_ins_attn_layers=1,
                            use_instruction=True, use_goal=True, use_goal_at_test=False,
                            feat_scales_to_use=scales, attn_rounds=rounds,
                            gripper_loc_bounds=BOUNDS, device="cpu").eval()


@pytest.fixture(scope="module")
def head_inputs():
    """The 3 x 2 planner, its encoded context and one noisy trajectory."""
    model = _planner()
    batch = synthetic_trajectory_batch(2, 1, (IMAGE, IMAGE), LENGTH, seed=4)
    with torch.no_grad():
        context, _, _ = model.encode(batch["rgbs"], batch["pcds"], batch["instr"],
                                     batch["curr_gripper"], batch["action"])
    traj = 0.3 * torch.randn(2, LENGTH, model.internal_dim,
                             generator=torch.Generator().manual_seed(5))
    return model, context, traj


def _denoise(model, context, traj):
    with torch.no_grad():
        return model.prediction_head.denoise(traj, torch.zeros(2, LENGTH, dtype=torch.bool),
                                             torch.tensor([3, 1]), context)


def test_hook_sees_the_indices_the_head_gathers(head_inputs):
    model, context, traj = head_inputs
    head = model.prediction_head
    selected, attended = [], {}
    hooks = [head.traj_neighbours.register_forward_hook(
        lambda module, args, idx: selected.append(idx))]

    def attend(i):
        def keep(module, args):
            attended[i] = args[0]  # returns None: the arguments pass unchanged
        return keep

    hooks += [getattr(head, f"vl_attention_{i}").register_forward_pre_hook(attend(i))
              for i in SELECTING]
    try:
        outputs = _denoise(model, context, traj)
    finally:
        for h in hooks:
            h.remove()
    assert len(selected) == len(SELECTING) == 4
    for idx, i in zip(selected, SELECTING):
        scale = i % SCALES
        k = (64 if scale == 1 else 16) * LENGTH
        assert idx.shape == (2, k)
        # the points nearest the previous block's trajectory ...
        want = find_traj_nn(outputs[i - 1][..., :3], context["pcd_pyramid"][scale],
                            nn_per_step=k // LENGTH)
        assert torch.equal(idx, want), i
        # ... are the tokens the block's vision-language stack attends from
        feats = context["rgb_feats_pyramid"][scale]
        assert torch.equal(attended[i], torch.gather(feats, 1, idx[..., None].expand(
            -1, -1, feats.shape[-1]))), i


def test_counters_step_by_selections_and_evaluations(head_inputs):
    model, context, traj = head_inputs
    calls, evaluations = find_traj_nn.calls, DiffusionHead.evaluations
    _denoise(model, context, traj)
    _denoise(model, context, traj)
    assert find_traj_nn.calls - calls == 2 * 4
    assert DiffusionHead.evaluations - evaluations == 2


def test_profiler_trace_holds_the_spans(head_inputs):
    model, context, traj = head_inputs
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _denoise(model, context, traj)
    names = Counter(e.name for e in prof.events())
    assert names["planner.knn"] == 4
    for scale in range(SCALES):
        assert names[f"planner.block.scale{scale}"] == ROUNDS, scale


def test_selection_adds_no_state_and_one_scale_builds_none(head_inputs):
    model = head_inputs[0]
    head = model.prediction_head
    assert not list(head.traj_neighbours.parameters())
    assert not list(head.traj_neighbours.buffers())
    keys = list(model.state_dict())
    assert not [k for k in keys if "traj_neighbours" in k]
    assert "prediction_head.rot_regressor_5_fc2.weight" in keys
    del head.traj_neighbours
    try:
        assert list(model.state_dict()) == keys
    finally:
        head.traj_neighbours = TrajectoryNeighbours()

    one = _planner(scales=1, rounds=1)
    assert not hasattr(one.prediction_head, "traj_neighbours")
    batch = synthetic_trajectory_batch(2, 1, (IMAGE, IMAGE), LENGTH, seed=4)
    with torch.no_grad():
        context, _, _ = one.encode(batch["rgbs"], batch["pcds"], batch["instr"],
                                   batch["curr_gripper"], batch["action"])
    calls, evaluations = find_traj_nn.calls, DiffusionHead.evaluations
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _denoise(one, context, torch.zeros(2, LENGTH, one.internal_dim))
    assert (find_traj_nn.calls - calls, DiffusionHead.evaluations - evaluations) == (0, 1)
    assert not [e.name for e in prof.events() if e.name.startswith("planner.")]
