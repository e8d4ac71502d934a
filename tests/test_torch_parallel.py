"""Data parallelism and FSDP of the port (``act3d_tpu_torch/parallel``) on
the CPU: ranks spawned over gloo (tests/torch_parallel_workers.py, a
FileStore rendezvous in tmp_path), held against the one-device run of the
same rank function in the test process.

* the counterparts of tests/test_sharding.py on its toy model: dp at 2 and
  4 ranks and fsdp (2, 2) equal to one device (rtol 1e-5 / atol 1e-6), the
  one-device run equal to JAX's, fsdp's per-rank trainable and moment
  bytes 1/F, JAX's divisibility errors, the fsdp checkpoint roundtrip in
  the one-device layout;
* the ChainedDiffuser (dropout 0.1, trajectory padding that differs
  between the ranks) at dp2 and dp2 x fsdp2, and Act3D at dp2, at JAX's
  rtol 2e-4 on the losses and its per-leaf scaled gradient rule;
* a bf16 step under DDP and under FSDP2 against the unwrapped bf16 step
  (tests/test_torch_bf16.py's loss and gradient bounds);
* the attention and elementwise dropout masks of each rank equal to the
  rows of the one-device masks, ``all_gather_metrics`` over 2 ranks;
* the ranks' rows of a CLI batch bit-identical to the one-device batch,
  and both training CLIs at 2 ranks: rank 0 alone writes, resume, the
  ``.pt`` layout of a one-device run, read by ``eval/main.py``.
"""

import math

import numpy as np
import pytest
import torch

from tests import torch_parallel_workers as W

TOY_STEPS = 5


@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(0)
    params = {"w1": (rng.normal(size=(6, 16)) * 0.3).astype(np.float32),
              "w2": (rng.normal(size=(16, 4)) * 0.3).astype(np.float32)}
    batch = {"x": rng.normal(size=(16, 6)).astype(np.float32),
             "y": rng.normal(size=(16, 4)).astype(np.float32)}
    return params, batch, W.toy_run(0, 1, 1, params, batch, TOY_STEPS)


def _assert_toy_equal(ref, run):
    np.testing.assert_allclose(ref["losses"], run["losses"], rtol=1e-5)
    for k in ref["params"]:
        np.testing.assert_allclose(ref["params"][k], run["params"][k], atol=1e-6)


def test_toy_single_device_matches_jax(toy):
    import jax

    from act3d_tpu.parallel.mesh import make_mesh
    from act3d_tpu.train.engine import Trainer

    params, batch, ref = toy

    def loss_fn(p, b, key):
        pred = jax.numpy.tanh(b["x"] @ p["w1"]) @ p["w2"]
        return jax.numpy.mean((pred - b["y"]) ** 2), {}

    trainer = Trainer(loss_fn, params, mesh=make_mesh(num_devices=1), lr=1e-2)
    losses = [float(trainer.step(batch, jax.random.PRNGKey(i))["loss"])
              for i in range(TOY_STEPS)]
    np.testing.assert_allclose(ref["losses"], losses, rtol=1e-5)
    got = jax.device_get(trainer.state.params)
    for k in params:
        np.testing.assert_allclose(ref["params"][k], got[k], atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_training_matches_single_device(tmp_path, toy, world):
    params, batch, ref = toy
    runs = W.spawn(W.toy_run, world, tmp_path, 1, params, batch, TOY_STEPS)
    for run in runs:
        _assert_toy_equal(ref, run)
        assert run["param_types"] == ["Parameter"]


@pytest.mark.parametrize("fsdp", [1, 2], ids=["ddp", "fsdp2"])
def test_gradient_accumulation_matches_single_device(tmp_path, toy, fsdp):
    """Two micro-batches per optimizer step at 2 ranks: the first keeps its
    gradients local (DDP's no_sync, FSDP2's set_requires_gradient_sync),
    the second synchronises the sum; equal to one device's accumulation."""
    params, batch, _ = toy
    ref = W.toy_run(0, 1, 1, params, batch, 6, None, 2)
    for run in W.spawn(W.toy_run, 2, tmp_path, fsdp, params, batch, 6, None, 2):
        _assert_toy_equal(ref, run)


@pytest.fixture(scope="module")
def fsdp_runs(tmp_path_factory, toy):
    params, batch, _ = toy
    tmp = tmp_path_factory.mktemp("fsdp")
    train = W.spawn(W.toy_run, 4, tmp, 2, params, batch, TOY_STEPS)
    ckpt = W.spawn(W.toy_run, 4, tmp, 2, params, batch, TOY_STEPS, str(tmp / "ckpt"))
    return tmp, train, ckpt


def test_fsdp_training_matches_single_device(fsdp_runs, toy):
    _, runs, _ = fsdp_runs
    for run in runs:
        _assert_toy_equal(toy[2], run)


def test_fsdp_actually_shards_params_and_moments(fsdp_runs, toy):
    """(dp, fsdp) = (2, 2): each rank holds half of every trainable
    parameter (dim 0) and of its two AdamW moments."""
    _, runs, _ = fsdp_runs
    full = sum(v.size * 4 for v in toy[0].values())
    ref = toy[2]
    assert ref["local_bytes"] == full and ref["local_moment_bytes"] == 2 * full
    for run in runs:
        assert run["param_types"] == ["DTensor"]
        assert run["local_bytes"] == full // 2
        assert run["local_moment_bytes"] == full


def test_fsdp_checkpoint_roundtrip(fsdp_runs, toy, tmp_path):
    """save / load of an fsdp Trainer: rank 0 writes best.pt and last.pt in
    the one-device layout; a new Trainer resumes at the step with equal
    params and takes the same next step."""
    tmp, _, runs = fsdp_runs
    for run in runs:
        assert run["resumed_step"] == 2 and run["resumed_params_equal"]
        assert run["next_losses"][0] == pytest.approx(run["next_losses"][1], rel=1e-6)
    assert runs[0]["files"] == ["best.pt", "last.pt"]
    W.toy_run(0, 1, 1, toy[0], toy[1], TOY_STEPS, str(tmp_path))
    want = W.state_layout(tmp_path / "last.pt")
    assert W.state_layout(tmp / "ckpt" / "last.pt") == want
    assert all(t == "Tensor" for _, _, t in want["model"].values())


def test_mesh_and_batch_divisibility_raise_jax_errors():
    from act3d_tpu.parallel.mesh import make_mesh as jax_mesh
    from act3d_tpu.parallel.mesh import shard_batch
    from act3d_tpu_torch.parallel.mesh import batch_rows, local_batch_size, make_mesh

    with pytest.raises(ValueError) as want:
        shard_batch({"x": np.zeros((10, 3), np.float32)}, jax_mesh(num_devices=4))
    with pytest.raises(ValueError) as got:
        local_batch_size(10, 4)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="is not divisible by the 4-device dp mesh"):
        batch_rows(1, 4, {"x": np.zeros((10, 3))})
    with pytest.raises(ValueError, match="fsdp=3 does not divide the 4 devices"):
        make_mesh(4, 3, "cpu")
    with pytest.raises(ValueError, match="fsdp=2 does not divide the 1 devices"):
        make_mesh(-1, 2, "cpu")
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        make_mesh(2, 1, "cpu")  # one process cannot form a 2-device mesh
    assert make_mesh(-1, 1, "cpu") is None and make_mesh(1, 1, "cpu") is None


# ------------------------------------------------------------- the models
def _diffusion_batch():
    from act3d_tpu_torch.utils.testing import synthetic_trajectory_batch

    batch = {k: v.numpy() for k, v in
             synthetic_trajectory_batch(4, 2, (64, 64), 8, seed=1).items()}
    # rank 0's rows (0, 1) pad 5 and 2 points, rank 1's none: per-rank
    # counts 9 and 16 of the global 25
    batch["trajectory_mask"][0, -5:] = True
    batch["trajectory_mask"][1, -2:] = True
    batch["trajectory"][batch["trajectory_mask"]] = 0.0
    return batch


def _keypose_batch():
    from act3d_tpu_torch.utils.testing import synthetic_keypose_batch

    return {k: v.numpy() for k, v in synthetic_keypose_batch(4, 2, (128, 128), seed=2).items()}


BATCHES = {"diffusion": _diffusion_batch, "keypose": _keypose_batch}


def _assert_grads_close(g1, gn):
    """tests/test_sharding.py's rule: per-leaf scaled, leaves at the noise
    floor (< 1e-6 of the largest gradient) skipped."""
    assert sorted(g1) == sorted(gn)
    gmax = max(np.abs(a).max() for a in g1.values())
    checked = 0
    for k in g1:
        scale = max(np.abs(g1[k]).max(), np.abs(gn[k]).max())
        if scale < 1e-6 * gmax:
            continue
        checked += 1
        np.testing.assert_allclose(g1[k] / scale, gn[k] / scale, atol=5e-4, rtol=0,
                                   err_msg=k)
    assert checked > 10


@pytest.mark.parametrize("kind,world,fsdp", [("diffusion", 2, 1), ("keypose", 2, 1),
                                             ("diffusion", 4, 2)],
                         ids=["diffusion-dp2", "act3d-dp2", "diffusion-dp2xfsdp2"])
def test_model_matches_single_device(tmp_path, kind, world, fsdp):
    """JAX's test_{act3d,diffusion}_dp_matches_single_device on the port:
    gradients and 3 steps of losses of the global batch at ``world`` ranks
    equal the one-device run's; the ChainedDiffuser drops out (0.1) and its
    ranks hold different numbers of padded trajectory points."""
    batch = BATCHES[kind]()
    if kind == "diffusion":
        counts = (~batch["trajectory_mask"]).sum(axis=1)
        assert counts[:2].sum() != counts[2:].sum()  # uneven over the dp2 ranks
    ref = W.model_run(0, 1, kind, 1, batch, 3)
    for run in W.spawn(W.model_run, world, tmp_path, kind, fsdp, batch, 3):
        np.testing.assert_allclose(ref["losses"], run["losses"], rtol=2e-4)
        _assert_grads_close(ref["grads"], run["grads"])


def _cos(a, b):
    a, b = torch.as_tensor(a).double().flatten(), torch.as_tensor(b).double().flatten()
    return torch.nn.functional.cosine_similarity(a, b, dim=0).item()


@pytest.mark.parametrize("fsdp", [1, 2], ids=["ddp", "fsdp2"])
def test_bf16_step_under_wrappers_matches_unwrapped(tmp_path, fsdp):
    """--mixed_precision 1 at 2 ranks: the loss within 2e-2 relative of the
    unwrapped bf16 step's and the whole trained gradient within cosine 0.99
    and relative L2 5e-2 (tests/test_torch_bf16.py's bounds); master
    parameters float32."""
    batch = _diffusion_batch()
    ref = W.model_run(0, 1, "diffusion", 1, batch, 2, True)
    for run in W.spawn(W.model_run, 2, tmp_path, "diffusion", fsdp, batch, 2, True):
        np.testing.assert_allclose(ref["losses"], run["losses"], rtol=2e-2)
        names = sorted(ref["grads"])
        assert names == sorted(run["grads"])
        g = np.concatenate([run["grads"][n].ravel() for n in names])
        w = np.concatenate([ref["grads"][n].ravel() for n in names])
        assert _cos(g, w) >= 0.99 and np.linalg.norm(g - w) / np.linalg.norm(w) <= 5e-2
        assert run["master_dtypes"] == ["torch.float32"]


# ------------------------------------------------- dropout and collectives
def test_dropout_b0_masks_are_rows_of_the_full_batch_mask():
    from act3d_tpu_torch.kernels.attention import dropout_keep

    full = dropout_keep(11, 8, 4, 6, 40, 0.3)
    for b0 in (0, 2, 5):
        assert torch.equal(dropout_keep(11, 3, 4, 6, 40, 0.3, b0=b0), full[b0:b0 + 3])
    assert torch.equal(dropout_keep(11, 8, 4, 6, 40, 0.3, b0=0), full)
    assert not torch.equal(full[:4], full[4:])  # rank 1's rows drop other weights


def test_rank_dropout_masks_are_rows_of_single_device_masks(tmp_path):
    keep1, elem1 = W.dropout_masks(0, 1, 5, 4, 2, 6, 30, 0.2)
    runs = W.spawn(W.dropout_masks, 2, tmp_path, 5, 2, 2, 6, 30, 0.2)
    for r, (keep, elem) in enumerate(runs):
        np.testing.assert_array_equal(keep, keep1[2 * r:2 * r + 2])
        np.testing.assert_array_equal(elem, elem1[2 * r:2 * r + 2])
    assert not np.array_equal(runs[0][0], runs[1][0])
    assert not np.array_equal(runs[0][1], runs[1][1])


def test_plain_fused_mha_with_b0_is_the_full_batch_slice():
    from act3d_tpu_torch.kernels.attention import FusedMHA

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(6, n, 16, generator=g, requires_grad=True) for n in (5, 9, 9))
    full = FusedMHA.apply(q, k, v, 2, None, 0.25, 77)
    full.sum().backward()
    grads = [t.grad.clone() for t in (q, k, v)]
    part = [t.detach()[2:5].clone().requires_grad_() for t in (q, k, v)]
    out = FusedMHA.apply(*part, 2, None, 0.25, 77, 2)
    out.sum().backward()
    torch.testing.assert_close(out, full[2:5], rtol=0, atol=0)
    for p, gfull in zip(part, grads):
        torch.testing.assert_close(p.grad, gfull[2:5], rtol=1e-6, atol=1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b0", [1, 3, 8])
@pytest.mark.parametrize("l,s", [(50, 53), (50, 3074), (133, 70)])
def test_cuda_kernels_with_b0_match_full_batch_rows(l, s, b0, dtype):
    """On the card: the forward and backward kernels on rows b0.. of a
    batch (dropout 0.1, dropout_b0=b0) equal the plain version of the
    whole batch there, at float32 tolerances (phase_train_kernels'), and
    the bf16 entries lie within ``bf16_errors``' bound of the float32 plain
    version at b0 (chip_smoke's kernels_bf16 rule)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from act3d_tpu_torch.kernels.attention import (fused_mha_backward,
                                                   fused_mha_backward_reference,
                                                   fused_mha_forward,
                                                   fused_mha_forward_reference)

    dev, h, e, full = torch.device("cuda"), 8, 120, b0 + 3
    g = torch.Generator(device=dev).manual_seed(b0)
    q = torch.randn(full, l, e, generator=g, device=dev) * 15 ** -0.5
    k, v, go = (torch.randn(full, n, e, generator=g, device=dev) for n in (s, s, l))
    part = [x[b0:].contiguous().to(dtype) for x in (q, k, v, go)]
    out, stats = fused_mha_forward(*part[:3], h, None, True, 0.1, 5, dropout_b0=b0)
    grads = fused_mha_backward(*part[:3], out, stats, part[3], h, None, 0.1, 5, dropout_b0=b0)
    if dtype == torch.float32:
        want_out, want_stats = fused_mha_forward_reference(q, k, v, h, None, 0.1, 5)
        want = fused_mha_backward_reference(q, k, v, want_out, want_stats, go, h, None, 0.1, 5)
        torch.testing.assert_close(out, want_out[b0:], atol=2e-5, rtol=1e-4)
        torch.testing.assert_close(stats, want_stats[b0:], atol=2e-5, rtol=1e-4)
        for got, w in zip(grads, want):
            torch.testing.assert_close(got, w[b0:], atol=1e-4, rtol=1e-3)
    else:
        from act3d_tpu_torch.kernels import BWD_FLOOR, bf16_errors

        plain, _ = fused_mha_forward_reference(*part[:3], h, None, 0.1, 5, dropout_b0=b0)
        ref, _ = fused_mha_forward_reference(*(x.float() for x in part[:3]), h, None, 0.1, 5,
                                             dropout_b0=b0)
        assert bf16_errors(out, plain, ref)["ok"]
        plain_g = fused_mha_backward_reference(*part[:3], out, stats, part[3], h, None, 0.1, 5,
                                               dropout_b0=b0)
        ref_g = fused_mha_backward_reference(*(x.float() for x in part[:3]), out.float(),
                                             stats, part[3].float(), h, None, 0.1, 5,
                                             dropout_b0=b0)
        assert all(bf16_errors(*t, BWD_FLOOR)["ok"] for t in zip(grads, plain_g, ref_g))


def test_all_gather_metrics_over_two_ranks(tmp_path):
    from act3d_tpu_torch.parallel.collectives import all_gather_metrics

    assert all_gather_metrics({"a": 1}) == [{"a": 1}]  # identity on one process
    runs = W.spawn(W.gather_metrics, 2, tmp_path)
    for run in runs:
        assert run["gathered"] == [{"rank": 0, "v": 0.0}, {"rank": 1, "v": 1.5}]
        np.testing.assert_array_equal(run["synced"]["x"], [0, 1, 10, 11])
        assert run["any"] is True and run["none"] is False


# ------------------------------------------------------------------ CLIs
@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    import pickle

    from act3d_tpu_torch.data.fixtures import make_dataset_tree, make_instructions

    root = tmp_path_factory.mktemp("pdata")
    data = make_dataset_tree(root / "data", image_size=128, n_cam=1)
    instr = root / "instructions.pkl"
    instr.write_bytes(pickle.dumps(make_instructions()))
    return data, instr


@pytest.mark.parametrize("yaw", [0.0, 30.0])
def test_rank_rows_of_a_cli_batch_equal_the_single_device_batch(tree, yaw):
    """RLBenchDataset(rank, world): every rank draws the global batch and
    decodes its rows, bit for bit the one-device batch's, host Resize and
    Rotate on."""
    import pickle

    from act3d_tpu_torch.data.dataset import RLBenchDataset

    data, instr_path = tree
    with open(instr_path, "rb") as f:
        instr = pickle.load(f)
    kwargs = dict(root=data, instructions=instr, taskvar=[("pick_and_lift", 0)],
                  cameras=("wrist",), image_rescale=(0.75, 1.25), cache_size=4,
                  point_cloud_rotate_yaw_range=yaw, return_low_lvl_trajectory=True,
                  dense_interpolation=True, interpolation_length=8, seed=4, training=True)
    one = RLBenchDataset(**kwargs)
    ranks = [RLBenchDataset(**kwargs, rank=r, world=3) for r in range(3)]
    for _ in range(3):
        want = one.sample_batch(6)
        got = [ds.sample_batch(6) for ds in ranks]
        for key, value in want.items():
            joined = sum((g[key] for g in got), []) if key == "task" else \
                np.concatenate([g[key] for g in got])
            np.testing.assert_array_equal(joined, value, err_msg=key)
    with pytest.raises(ValueError, match="not divisible by the 3-device"):
        ranks[0].sample_batch(4)


CLI_FLAGS = {
    "keypose": ["--embedding_dim", "12", "--num_ghost_points", "32",
                "--num_ghost_points_val", "32", "--num_ghost_point_cross_attn_layers", "1",
                "--num_query_cross_attn_layers", "1", "--num_vis_ins_attn_layers", "1"],
    "trajectory": ["--embedding_dim", "24", "--num_query_cross_attn_layers", "1",
                   "--num_vis_ins_attn_layers", "1", "--diffusion_timesteps", "5",
                   "--interpolation_length", "8", "--dense_interpolation", "1",
                   "--use_goal", "1"],
}
# the mesh of each CLI's 2-rank run
CLI_MESH = {"keypose": ["--num_devices", "2"], "trajectory": ["--num_devices", "2", "--fsdp", "2"]}


def _cli_argv(tree, log_root, name, *extra):
    data, instr = tree
    return ["--device", "cpu", "--dataset", str(data), "--valset", str(data),
            "--instructions", str(instr), "--tasks", "pick_and_lift", "--use_instruction", "1",
            "--image_size", "128,128", "--cameras", "wrist", "--batch_size", "4",
            "--batch_size_val", "2", "--train_iters", "2", "--val_freq", "2",
            "--base_log_dir", str(log_root), "--exp_log_dir", name, *CLI_FLAGS[name], *extra]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, tree):
    """Each CLI at 2 ranks (2 steps, then a relaunch to step 3 with
    --val_freq 3) and at one device (2 steps)."""
    root = tmp_path_factory.mktemp("pcli")
    runs = {}
    for name in CLI_FLAGS:
        argv = _cli_argv(tree, root / "dp", name, *CLI_MESH[name])
        runs[name] = W.spawn(W.cli_run, 2, root, name, [argv, argv + ["--train_iters", "3", "--val_freq", "3"]])
        W.cli_run(0, 1, name, [_cli_argv(tree, root / "one", name)])
    return root, runs


@pytest.mark.parametrize("name", sorted(CLI_FLAGS))
def test_clis_train_at_two_ranks(cli_runs, name):
    """``main()`` on 2 ranks (dp2; dp1 x fsdp2 for the trajectory CLI):
    the same finite loss on both ranks, rank 0's files only (one metrics
    line per evaluation, the relaunch's included), and best.pt in the layout of a one-device run of the same flags:
    the same keys, shapes and dtypes, plain tensors, the same optimizer
    parameter ids and state keys."""
    root, runs = cli_runs
    first = [r[0]["evals"] for r in runs[name]]
    assert len(first[0]) == 1 and first[0] == first[1]
    assert math.isfinite(first[0][0]["loss"])
    log_dir = root / "dp" / name / "run"
    assert sorted(p.name for p in log_dir.iterdir()) == [
        "best.pt", "hparams.json", "last.pt", "metrics.jsonl"]
    assert len((log_dir / "metrics.jsonl").read_text().splitlines()) == 2
    one = W.state_layout(root / "one" / name / "run" / "best.pt")
    got = W.state_layout(log_dir / "best.pt")
    assert got["model"] == one["model"] and got["opt_ids"] == one["opt_ids"]
    assert got["opt_state"] == one["opt_state"] and got["keys"] == one["keys"]


@pytest.mark.parametrize("name", sorted(CLI_FLAGS))
def test_clis_resume_at_two_ranks(cli_runs, name):
    """The relaunch with --train_iters 3 --val_freq 3 resumes from last.pt
    at step 2 on both ranks: one step, its evaluation with the same loss on
    both ranks, last.pt at step 3."""
    root, runs = cli_runs
    again = [r[1]["evals"] for r in runs[name]]
    assert [[e["step"] for e in ev] for ev in again] == [[2], [2]] and again[0] == again[1]
    assert torch.load(root / "dp" / name / "run" / "last.pt",
                      weights_only=True)["step"] == 3


def test_eval_cli_loads_checkpoints_of_two_rank_runs(cli_runs, tree):
    """eval/main.py builds both models at the training widths and loads the
    dp2 Act3D and the fsdp2 planner best.pt files (strict)."""
    import argparse

    from act3d_tpu_torch.eval.main import build_models

    root, _ = cli_runs
    args = argparse.Namespace(
        image_size="128,128", keypose_embedding_dim=12, traj_embedding_dim=24,
        num_ghost_points=32, num_ghost_points_val=32, num_sampling_level=3,
        num_ghost_point_cross_attn_layers=1, keypose_query_cross_attn_layers=1,
        num_vis_ins_attn_layers=1, num_query_cross_attn_layers=1, diffusion_timesteps=5,
        use_instruction=1, device="cpu",
        keypose_ckpt=str(root / "dp" / "keypose" / "run" / "best.pt"),
        traj_ckpt=str(root / "dp" / "trajectory" / "run" / "best.pt"))
    keypose, planner = build_models(args, [[-2.0] * 3, [2.0] * 3])
    saved = torch.load(args.traj_ckpt, weights_only=True)["model"]
    for k, v in planner.state_dict().items():
        assert torch.equal(v, saved[k]), k
