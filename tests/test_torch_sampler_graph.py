"""The sampler's shared reverse step and its CUDA graphs
(``models/diffusion_planner.py::reverse_step``, ``models/sampler_graph.py``).

On the CPU: the reverse step run with the step index as a device tensor,
through the static buffers a captured step reads, gives bitwise the
trajectories of the eager loop as it was before the step was shared (a
frozen copy below), step by step from t = 99 to the final step, for the 6D
and the quaternion heads and a padded mask held to its goal
(``use_goal_at_test``); ``DDPMSchedule.step`` gives the same numbers with a
tensor index as with an int; an Actioner on the CPU and the trajectory
training CLI's sampler eval run every step eagerly.

On the card (``-m gpu``; skipped without one): the graph path of
``compute_trajectory`` against its eager loop, bitwise, with the ``noise``
override, with a generator, over two observations in a row, with a padded
mask, and for the multi-scale head; a step that cannot be captured warns
and runs eagerly, bitwise; 2 captures over 5 keysteps and 1918 attention
calls a keystep at the serving widths; the Actioner and the Trainer run on
the device's one graph stream.  Nothing here imports JAX:

    python -m pytest --noconftest tests/test_torch_sampler_graph.py -m gpu
"""

import numpy as np
import pytest
import torch

from act3d_tpu_torch.device import graph_stream
from act3d_tpu_torch.eval.actioner import Actioner
from act3d_tpu_torch.models import Act3D, DiffusionPlanner, compute_trajectory
from act3d_tpu_torch.models.diffusion_planner import reverse_step
from act3d_tpu_torch.models import sampler_graph
from act3d_tpu_torch.models.sampler_graph import SamplerGraphs, _Step
from act3d_tpu_torch.ops.attention import multi_head_attention
from act3d_tpu_torch.ops.schedulers import CLIP_SAMPLE_RANGE, make_ddpm_schedule
from act3d_tpu_torch.utils.testing import BOUNDS

NCAM, IMAGE, N_INSTR, LENGTH = 1, 64, 7, 8
PLANNER = dict(image_size=(IMAGE, IMAGE), embedding_dim=24, num_query_cross_attn_layers=3,
               num_vis_ins_attn_layers=1, use_instruction=True, use_goal=True,
               gripper_loc_bounds=BOUNDS)
# (rotation parametrization, use_goal_at_test, padded rows at the mask's end)
HEADS = {"6D": ("6D", False, 0), "quat": ("quat_from_query", False, 0),
         "padded_goal": ("6D", True, 3)}
gpu = pytest.mark.gpu


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the steps' ops are tiny, and the suite runs
    beside other test processes, where more threads only contend for the
    same cores (hundreds of times slower here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planner(name, device, steps=100, **options):
    rotation, goal_at_test, _ = HEADS[name]
    torch.manual_seed(0)
    model = DiffusionPlanner(**dict(PLANNER, **options), output_dim=7,
                             rotation_parametrization=rotation, use_goal_at_test=goal_at_test,
                             diffusion_timesteps=steps, device=device)
    return model.eval()


def _inputs(name, model, seed=1, device="cpu"):
    """(mask, rgb, pcd, instruction, curr, goal, noise) of one observation."""
    g = torch.Generator().manual_seed(seed)
    lo, hi = (torch.tensor(b) for b in BOUNDS)
    mask = torch.zeros(1, LENGTH, dtype=torch.bool)
    mask[0, LENGTH - HEADS[name][2]:] = True
    rgb = torch.rand(1, NCAM, 3, IMAGE, IMAGE, generator=g)
    pcd = (lo + (hi - lo) * torch.rand(1, NCAM, IMAGE, IMAGE, 3, generator=g)).movedim(-1, 2)
    instr = torch.randn(1, N_INSTR, 512, generator=g)
    poses = []
    for _ in range(2):
        quat = torch.randn(1, 4, generator=g)
        poses.append(torch.cat([lo + (hi - lo) * torch.rand(1, 3, generator=g),
                                quat / quat.norm()], dim=1))
    d, steps = model.internal_dim, model.diffusion_timesteps
    noise = (torch.randn(1, LENGTH, d, generator=g), torch.randn(steps, 1, LENGTH, d,
                                                                 generator=g))
    return [x.to(device) for x in (mask, rgb, pcd.contiguous(), instr, *poses)], tuple(
        n.to(device) for n in noise)


def _parent_schedule_step(schedule, model_output, t, sample, noise):
    """``DDPMSchedule.step`` before the shared step (frozen)."""
    x0 = torch.clamp(model_output, -CLIP_SAMPLE_RANGE, CLIP_SAMPLE_RANGE)
    prev = schedule.posterior_x0_coeff[t] * x0 + schedule.posterior_xt_coeff[t] * sample
    if t > 0:
        prev = prev + torch.sqrt(schedule.posterior_variance[t]) * noise
    return prev


def _conditioning(model, mask, curr, goal):
    b, length = mask.shape
    d = model.internal_dim
    positions = torch.arange(length)[None, :]
    last_valid = (length - mask.sum(dim=1) - 1)[:, None]
    cond_data = torch.zeros(b, length, d)
    cond_data = torch.where((positions == 0)[..., None], curr[:, None, :], cond_data)
    cond_mask = positions == 0
    if model.use_goal_at_test:
        cond_data = torch.where((positions == last_valid)[..., None], goal[:, None, :],
                                cond_data)
        cond_mask = cond_mask | (positions >= last_valid)
    return cond_data, cond_mask[..., None].expand(b, length, d)


def _parent_loop(model, mask, context, cond_data, cond_mask, noise):
    """``compute_trajectory``'s reverse loop before the shared step (frozen):
    the trajectory after every step."""
    b = mask.shape[0]
    trajectory, out = noise[0] + cond_data, []
    for i, t in enumerate(range(model.diffusion_timesteps - 1, -1, -1)):
        pred = model.denoise_step(trajectory, mask, torch.full((b,), t), context)
        pred = torch.where(cond_mask, cond_data, pred)
        if t == 0:
            out.append(pred)
            break
        eps = noise[1][i]
        pos = _parent_schedule_step(model.pos_schedule, pred[..., :3], t, trajectory[..., :3],
                                    eps[..., :3])
        rot = _parent_schedule_step(model.rot_schedule, pred[..., 3:9], t,
                                    trajectory[..., 3:9], eps[..., 3:9])
        trajectory = torch.cat([pos, rot], dim=-1)
        out.append(trajectory)
    return out


@pytest.mark.parametrize("name", sorted(HEADS))
def test_reverse_step_with_a_device_index_matches_the_parent_loop(name):
    """Every step of the captured body (static buffers, a one-element int64
    step index advanced by the step itself, the noise row and coefficients
    gathered by it), run eagerly on the CPU, against the frozen loop; and
    ``compute_trajectory`` against the frozen loop's trajectory."""
    model = _planner(name, "cpu")
    (mask, rgb, pcd, instr, curr, goal), noise = _inputs(name, model)
    with torch.no_grad():
        context, curr_n, goal_n = model.encode(rgb, pcd, instr, curr, goal)
        cond_data, cond_mask = _conditioning(model, mask, curr_n, goal_n)
        want = _parent_loop(model, mask, context, cond_data, cond_mask, noise)
        eps = noise[1][:-1]
        step = _Step(model, noise[0] + cond_data, mask, context, cond_data, cond_mask, eps)
        step.load(noise[0] + cond_data, mask, context, cond_data, cond_mask, eps)
        before = compute_trajectory.eager_steps
        for i, expected in enumerate(want):
            assert int(step.step) == i
            step.run(final=i == len(want) - 1)
            assert torch.equal(step.inputs[0], expected), f"step {i}: t = {99 - i}"
        assert compute_trajectory.eager_steps == before + 100
        # the int index through the same function: the first and last steps
        first = reverse_step(model, noise[0] + cond_data, mask, 0, context, cond_data,
                             cond_mask, noise[1][0])
        assert torch.equal(first, want[0])
        last = reverse_step(model, want[-2], mask, 99, context, cond_data, cond_mask)
        assert torch.equal(last, want[-1])
        got = compute_trajectory(model, mask, rgb, pcd, instr, curr, goal, noise=noise)
    final = want[-1]
    if model.rotation_parametrization != "6D":
        from act3d_tpu_torch.ops.rotations import normalise_quat
        final = torch.cat([final[..., :3], normalise_quat(final[..., 3:7]),
                           final[..., 7:]], dim=-1)
    final = model.unconvert_rot(final)
    final = torch.cat([model.unnormalize_pos(final[..., :3]), final[..., 3:]], dim=-1)
    assert torch.equal(got, final)


@pytest.mark.parametrize("schedule", ["scaled_linear", "squaredcos_cap_v2"])
def test_schedule_step_with_a_tensor_index_equals_the_int_index(schedule):
    s = make_ddpm_schedule(schedule, 100)
    g = torch.Generator().manual_seed(3)
    out, sample, noise = (torch.randn(2, 5, 6, generator=g) * 1.5 for _ in range(3))
    for t in range(100):
        eps = noise if t > 0 else None
        by_int = s.step(out, t, sample, eps)
        assert torch.equal(by_int, _parent_schedule_step(s, out, t, sample, noise)), t
        assert torch.equal(s.step(out, torch.tensor([t]), sample, eps), by_int), t


def _actioner(device, steps, planner_name="6D"):
    torch.manual_seed(0)
    act3d = Act3D(image_size=(IMAGE, IMAGE), embedding_dim=24, num_attn_heads=4,
                  num_sampling_level=2, use_instruction=True, num_ghost_points_val=60,
                  gripper_loc_bounds=BOUNDS, device="cpu")
    planner = _planner(planner_name, "cpu", steps)
    instr = np.random.default_rng(0).normal(size=(N_INSTR, 512)).astype(np.float32)
    actioner = Actioner(act3d, planner, instructions={"task": {0: [instr]}}, device=device)
    actioner.load_episode("task", 0)
    return actioner


def _keystep(actioner, seed):
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(BOUNDS, np.float32)
    rgb = rng.uniform(-1, 1, (1, NCAM, 3, IMAGE, IMAGE)).astype(np.float32)
    pcd = np.ascontiguousarray(rng.uniform(lo, hi, (1, NCAM, IMAGE, IMAGE, 3))
                               .astype(np.float32).transpose(0, 1, 4, 2, 3))
    quat = rng.normal(size=4)
    gripper = np.concatenate([rng.uniform(lo, hi), quat / np.linalg.norm(quat), [1.0]])
    dev = actioner.device
    ghosts = [torch.as_tensor(rng.uniform(lo, hi, (1, 10, 3)).astype(np.float32), device=dev)
              for _ in range(2)]
    return actioner.predict(rgb, pcd, gripper[None].astype(np.float32),
                            trajectory_mask=np.zeros((1, LENGTH), bool),
                            ghost_points_override=ghosts)


def _counters():
    return (compute_trajectory.eager_steps, compute_trajectory.replayed_steps,
            compute_trajectory.captures, multi_head_attention.calls)


def test_actioner_on_the_cpu_runs_every_step_eagerly():
    """No stream and no graphs of its own: every step eager, no replay, no
    capture, and a keystep's attention calls are Act3D's plus the steps'."""
    steps = 6
    actioner = _actioner("cpu", steps)
    assert actioner._stream is None
    keypose_only = Actioner(actioner.keypose_model, None, instructions=actioner._instructions,
                            predict_trajectory=False, device="cpu")
    keypose_only.load_episode("task", 0)
    calls = multi_head_attention.calls
    _keystep(keypose_only, 0)
    act3d_calls = multi_head_attention.calls - calls
    model = actioner.traj_model
    (mask, rgb, pcd, instr, curr, goal), noise = _inputs("6D", model)
    with torch.no_grad():
        context, curr_n, goal_n = model.encode(rgb, pcd, instr, curr, goal)
        cond_data, cond_mask = _conditioning(model, mask, curr_n, goal_n)
        calls = multi_head_attention.calls
        reverse_step(model, noise[0], mask, 0, context, cond_data, cond_mask, noise[1][0])
        step_calls = multi_head_attention.calls - calls
    for k in range(2):
        start = _counters()
        _keystep(actioner, k)
        assert [b - a for a, b in zip(start, _counters())] == [
            steps, 0, 0, act3d_calls + steps * step_calls]


def test_training_cli_sampler_eval_runs_every_step_eagerly(tmp_path, monkeypatch):
    """The trajectory CLI's sampler eval (``compute_trajectory`` through
    the Trainer's runner) builds no ``SamplerGraphs``: its steps run
    eagerly, none replays and nothing is captured."""
    import pickle

    from act3d_tpu_torch.data.fixtures import make_dataset_tree, make_instructions
    from act3d_tpu_torch.train import main_trajectory

    built = []
    monkeypatch.setattr(SamplerGraphs, "__init__", lambda self, *a, **k: built.append(a))
    tree = make_dataset_tree(tmp_path / "data", image_size=128, n_cam=1)
    (tmp_path / "instructions.pkl").write_bytes(pickle.dumps(make_instructions()))
    start = _counters()
    out = main_trajectory.main([
        "--dataset", str(tree), "--valset", str(tree), "--tasks", "pick_and_lift",
        "--instructions", str(tmp_path / "instructions.pkl"), "--use_instruction", "1",
        "--image_size", "128,128", "--cameras", "wrist", "--batch_size", "2",
        "--batch_size_val", "2", "--base_log_dir", str(tmp_path / "logs"), "--device", "cpu",
        "--embedding_dim", "24", "--num_query_cross_attn_layers", "1",
        "--num_vis_ins_attn_layers", "1", "--diffusion_timesteps", "5", "--use_goal", "1",
        "--train_iters", "1", "--val_freq", "1"])
    assert len(out["evals"]) == 1
    eager, replayed, captures = (b - a for a, b in zip(start[:3], _counters()[:3]))
    assert eager > 0 and eager % 5 == 0  # --diffusion_timesteps 5 a sample
    assert replayed == captures == 0 and not built


# --------------------------------------------------------------- on the card


@pytest.fixture
def card():
    """Skips the test when no CUDA device is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _sample(model, inputs, noise=None, generator=None, graphs=None, stream=None):
    with torch.cuda.stream(stream), torch.no_grad():
        out = compute_trajectory(model, *inputs, noise=noise, generator=generator,
                                 graphs=graphs)
    torch.cuda.synchronize()
    return out


def _graph_and_eager(name, keysteps=2, **options):
    """Per observation seed: (graph path, eager loop) trajectories, the
    graph path on one SamplerGraphs over ``keysteps`` observations, both on
    one side stream; and the counter deltas of the graph path."""
    model = _planner(name, "cuda", **options)
    stream, graphs = torch.cuda.Stream(), SamplerGraphs()
    pairs, start = [], _counters()
    for seed in range(1, keysteps + 1):
        inputs, noise = _inputs(name, model, seed, "cuda")
        got = _sample(model, inputs, noise, graphs=graphs, stream=stream)
        pairs.append((got, _sample(model, inputs, noise, stream=stream)))
    eager = model.diffusion_timesteps * keysteps
    counted = [b - a for a, b in zip(start, _counters())]
    counted[0] -= eager  # the eager loop's own steps
    return pairs, counted


@gpu
@pytest.mark.parametrize("name", sorted(HEADS))
def test_graph_path_equals_the_eager_loop_bitwise(card, name):
    """The ``noise`` override over two observations in a row (so the
    context is copied into the buffers again), every head incl. a padded
    mask held to its goal: bitwise equal, 1 eager step and 2 captures at
    the first observation, 199 replays."""
    pairs, counted = _graph_and_eager(name)
    for got, want in pairs:
        assert torch.equal(got, want), (got - want).abs().max().item()
    assert counted[:3] == [1, 199, 2]


@gpu
def test_graph_path_draws_the_eager_loops_noise_from_a_generator(card):
    model = _planner("6D", "cuda")
    inputs, _ = _inputs("6D", model, 4, "cuda")
    stream, graphs = torch.cuda.Stream(), SamplerGraphs()
    outs = []
    for use_graphs in (True, True, False):
        gen = torch.Generator(device="cuda").manual_seed(11)
        outs.append(_sample(model, inputs, generator=gen, stream=stream,
                            graphs=graphs if use_graphs else None))
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[2])


@gpu
def test_multi_scale_head_equals_the_eager_loop(card):
    """3 scales x 2 rounds with ``use_goal``: the scales above 0 attend to
    the points ``find_traj_nn`` picks; captured, or run eagerly where the
    capture fails (the counters say which)."""
    pairs, counted = _graph_and_eager("6D", feat_scales_to_use=3, attn_rounds=2)
    for got, want in pairs:
        assert torch.equal(got, want), (got - want).abs().max().item()
    assert counted[:3] in ([1, 199, 2], [200, 0, 0]), counted
    print(f"multi-scale head: eager, replayed, captures {counted[:3]}")


@gpu
def test_a_step_that_cannot_be_captured_warns_and_runs_eagerly(card, monkeypatch):
    """A step that reads a number on the host is refused under capture: the
    capture warns with the error, and both observations run every step
    eagerly (none replayed, none captured), bitwise the eager loop."""
    step = sampler_graph.reverse_step

    def host_reading(*args, **kwargs):
        out = step(*args, **kwargs)
        float(out.sum())
        return out

    monkeypatch.setattr(sampler_graph, "reverse_step", host_reading)
    with pytest.warns(UserWarning, match="not captured, runs eagerly"):
        pairs, counted = _graph_and_eager("6D")
    for got, want in pairs:
        assert torch.equal(got, want), (got - want).abs().max().item()
    assert counted[:3] == [200, 0, 0]


@gpu
def test_actioner_and_trainer_run_on_the_devices_graph_stream(card):
    from act3d_tpu_torch.train.engine import Trainer

    model = torch.nn.Linear(2, 2).cuda()
    trainer = Trainer(lambda batch, generators: (model(batch).sum(), {}), model)
    stream = graph_stream(torch.device("cuda"))
    assert _actioner("cuda", 3)._stream is stream and trainer._stream is stream
    assert graph_stream(torch.device("cuda", torch.cuda.current_device())) is stream


@gpu
def test_serving_keysteps_capture_twice_and_count_every_attention_call(card, monkeypatch):
    """The serving widths (chip_smoke's phase_serve): 5 keysteps, 2
    captures, 1 eager step, 499 replays, 1918 ``multi_head_attention``
    calls and fused-MHA launches a keystep.  Prints the capture's host
    seconds and each keystep's."""
    import time

    import chip_smoke
    from act3d_tpu_torch.kernels.attention import fused_mha_forward

    capture, seconds = _Step.capture, []

    def timed(self):
        t0 = time.perf_counter()
        capture(self)
        seconds.append(time.perf_counter() - t0)

    monkeypatch.setattr(_Step, "capture", timed)

    rng = np.random.default_rng(0)
    bank = rng.normal(size=(chip_smoke.N_INSTR, 512)).astype(np.float32)
    actioner = chip_smoke.build_actioner(chip_smoke.ACT3D_CFG, chip_smoke.PLANNER_CFG, "cuda",
                                         {"synthetic": {0: [bank]}})
    actioner.load_episode("synthetic", 0)
    mask = np.zeros((1, chip_smoke.TRAJ_LEN), bool)
    start, keysteps = _counters(), []
    for _ in range(5):
        calls, launches = multi_head_attention.calls, fused_mha_forward.launches
        rgb, pcd, gripper = chip_smoke.synthetic_observation(rng, 256, chip_smoke.NCAM)
        t0 = time.perf_counter()
        out = actioner.predict(rgb, pcd, gripper, trajectory_mask=mask)
        keysteps.append(time.perf_counter() - t0)
        assert np.isfinite(out["trajectory"]).all()
        assert multi_head_attention.calls - calls == 1918
        assert fused_mha_forward.launches - launches == 1918
    assert [b - a for a, b in zip(start, _counters())][:3] == [1, 499, 2]
    print(f"capture {seconds[0]:.4f} s; keysteps "
          + " ".join(f"{x * 1e3:.1f}" for x in keysteps) + " ms | "
          + torch.cuda.get_device_name())
