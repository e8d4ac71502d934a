"""The port's training CLIs on the CPU.

Both ``main()`` run with ``--device cpu`` over a fixture tree written by
the port's own fixture writer, at the basic widths of
``scripts/drive_fixture_clis.py`` (128^2, one camera, emb 12 / 24, 32 ghost
points, one layer per attention stack, 5 diffusion steps, ``--train_iters 2
--val_freq 2``): finite losses, ``best.pt`` / ``last.pt`` / ``hparams.json``
/ ``metrics.jsonl``, a relaunch that resumes at step 2, ``--eval_only``;
each host-path flag (``--num_workers 2``, ``--device_augment``,
``--compact_transfer``, ``--wire depth``, ``--instr_mode ids``,
``--use_tensorboard``) and the two combinations chip_smoke runs train to a
checkpoint with the batches that flag ships; ``--device_augment 1 --wire
depth`` raises ValueError, as in JAX; ``--mixed_precision 1`` trains in
bf16 to float32 checkpoints; each model option of JAX's CLIs
(``--backbone resnet``, the rotation parametrizations, untied levels,
``--approx_topk``, ``--feat_scales_to_use``, ``--attn_rounds``) trains to a
checkpoint of the model it builds; JAX's ValueError for ``--num_devices``
/ ``--fsdp`` a single process cannot form a mesh of.  Without a card, the
default device raises.  Nothing here imports JAX.
"""

import json
import math
import pickle

import pytest
import torch

from act3d_tpu_torch.data.fixtures import make_dataset_tree, make_instructions
from act3d_tpu_torch.train import main_keypose, main_trajectory
from act3d_tpu_torch.train.engine import Trainer

KEYPOSE = ["--embedding_dim", "12", "--num_ghost_points", "32", "--num_ghost_points_val", "32",
           "--num_ghost_point_cross_attn_layers", "1", "--num_query_cross_attn_layers", "1",
           "--num_vis_ins_attn_layers", "1"]
TRAJECTORY = ["--embedding_dim", "24", "--num_query_cross_attn_layers", "1",
              "--num_vis_ins_attn_layers", "1", "--diffusion_timesteps", "5", "--use_goal", "1",
              "--dense_interpolation", "1", "--interpolation_length", "12"]
CLIS = {"keypose": (main_keypose, KEYPOSE), "trajectory": (main_trajectory, TRAJECTORY)}


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads per CLI run: the suite runs beside other test
    processes, where more threads only contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def common(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    tree = make_dataset_tree(tmp / "data", image_size=128, n_cam=1)
    ipath = tmp / "instructions.pkl"
    ipath.write_bytes(pickle.dumps(make_instructions()))
    return tmp, [
        "--dataset", str(tree), "--valset", str(tree), "--tasks", "pick_and_lift",
        "--instructions", str(ipath), "--use_instruction", "1", "--image_size", "128,128",
        "--cameras", "wrist", "--val_freq", "2", "--batch_size", "2", "--batch_size_val", "2",
        "--base_log_dir", str(tmp / "logs"), "--cache_size", "4", "--cache_size_val", "4",
        "--device", "cpu",
    ]


@pytest.fixture
def steps_taken(monkeypatch):
    """(step_count before the step, loss) of every Trainer.step call."""
    taken = []
    step = Trainer.step

    def recorded(self, batch):
        start = self.step_count
        out = step(self, batch)
        taken.append((start, float(out["loss"])))
        return out

    monkeypatch.setattr(Trainer, "step", recorded)
    return taken


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_trains_checkpoints_resumes_and_evaluates(common, steps_taken, name):
    tmp, args = common
    main, widths = CLIS[name]
    argv = args + widths + ["--run_log_dir", name]
    log_dir = tmp / "logs" / "exp" / name

    out = main.main(argv + ["--train_iters", "2"])
    assert [s for s, _ in steps_taken] == [0, 1]
    assert all(math.isfinite(loss) for _, loss in steps_taken)
    (evaluation,) = out["evals"]
    assert evaluation["step"] == 1 and evaluation["loss"] == steps_taken[-1][1]
    key = "mean/pos_l2_final" if name == "keypose" else "traj_action_mse"
    assert math.isfinite(evaluation["val"][key]), evaluation
    assert {p.name for p in log_dir.iterdir()} == {"best.pt", "last.pt", "hparams.json",
                                                    "metrics.jsonl"}
    hparams = json.loads((log_dir / "hparams.json").read_text())
    assert hparams["device"] == "cpu" and hparams["train_iters"] == 2
    (line,) = [json.loads(x) for x in (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert line["step"] == 1 and f"val-losses/{key}" in line
    assert line["time/step_s"] > 0 and line["time/data_wait_s"] >= 0, line
    last = torch.load(log_dir / "last.pt", weights_only=True)
    assert last["step"] == 2

    # the same command line with more steps goes on from last.pt
    out = main.main(argv + ["--train_iters", "3"])
    assert [s for s, _ in steps_taken[2:]] == [2] and not out["evals"]
    assert math.isfinite(steps_taken[-1][1])

    metrics = main.main(argv + ["--train_iters", "3", "--eval_only", "1"])
    assert metrics and all(math.isfinite(v) for v in metrics.values())


# (name, CLI, flags): each host-path flag alone, then the two combinations
# chip_smoke runs on the card
HOST_PATH = [
    ("num_workers", "keypose", ["--num_workers", "2"]),
    ("device_augment", "keypose", ["--device_augment", "1",
                                   "--point_cloud_rotate_yaw_range", "10.0"]),
    ("compact_transfer", "keypose", ["--compact_transfer", "1"]),
    ("wire_depth", "trajectory", ["--wire", "depth"]),
    ("instr_mode_ids", "keypose", ["--instr_mode", "ids"]),
    ("use_tensorboard", "trajectory", ["--use_tensorboard", "1"]),
    ("keypose_host_path", "keypose", ["--num_workers", "2", "--device_augment", "1",
                                      "--compact_transfer", "1", "--instr_mode", "ids"]),
    ("trajectory_host_path", "trajectory", ["--wire", "depth", "--instr_mode", "ids",
                                            "--use_tensorboard", "1"]),
]


@pytest.fixture
def host_path_calls(monkeypatch):
    """Counts the sampler's batches and the device resizes, and records the
    dtypes of every batch Trainer.step takes."""
    from act3d_tpu_torch.data import device_augment, pipeline

    calls = {"sampler": 0, "device_resize": 0, "batches": []}
    sampler_next, resize, step = (pipeline.MultiProcessSampler.__next__,
                                  device_augment.resize_sample, Trainer.step)

    def counted_next(self):
        calls["sampler"] += 1
        return sampler_next(self)

    def counted_resize(*args, **kwargs):
        calls["device_resize"] += 1
        return resize(*args, **kwargs)

    def recorded(self, batch):
        out = step(self, batch)
        calls["batches"].append(({k: v.dtype for k, v in batch.items()}, float(out["loss"])))
        return out

    monkeypatch.setattr(pipeline.MultiProcessSampler, "__next__", counted_next)
    monkeypatch.setattr(device_augment, "resize_sample", counted_resize)
    monkeypatch.setattr(Trainer, "step", recorded)
    return calls


@pytest.mark.parametrize("case,name,flags", HOST_PATH, ids=[c[0] for c in HOST_PATH])
def test_cli_trains_under_each_host_path_flag(common, host_path_calls, case, name, flags):
    tmp, args = common
    main, widths = CLIS[name]
    log_dir = tmp / "logs" / "exp" / case
    out = main.main(args + widths + ["--run_log_dir", case, "--train_iters", "2", *flags])
    steps = host_path_calls["batches"]
    assert len(steps) == 2 and all(math.isfinite(loss) for _, loss in steps)
    (evaluation,) = out["evals"]
    assert all(math.isfinite(v) for v in evaluation["val"].values()), evaluation
    assert (log_dir / "best.pt").exists() and (log_dir / "last.pt").exists()
    hparams = json.loads((log_dir / "hparams.json").read_text())
    dtypes = steps[-1][0]
    given = dict(zip(flags[::2], flags[1::2]))
    for flag, value in given.items():
        assert str(hparams[flag[2:]]) == value, flag
    workers = "--num_workers" in given
    assert (host_path_calls["sampler"] >= 2) == workers, host_path_calls
    assert (host_path_calls["device_resize"] == 2) == ("--device_augment" in given)
    depth = "--wire" in given
    if "--compact_transfer" in given or depth:  # the depth wire ships compact too
        assert dtypes["rgbs"] == torch.uint8
        assert dtypes["depth" if depth else "pcds"] == torch.uint16
    else:
        assert dtypes["rgbs"] == torch.float32
    assert ("pcds" not in dtypes) == depth and ("aug_rows" in dtypes) == depth
    ids = "--instr_mode" in given
    assert ("instr_id" in dtypes and "instr" not in dtypes) == ids
    events = list(log_dir.glob("events.out.tfevents.*"))
    assert bool(events) == ("--use_tensorboard" in given)


def test_cli_device_augment_with_the_depth_wire_raises_as_jax(common):
    tmp, args = common
    main, widths = CLIS["trajectory"]
    with pytest.raises(ValueError, match="does not compose with --wire depth"):
        main.main(args + widths + ["--run_log_dir", "augment_depth", "--train_iters", "2",
                                   "--device_augment", "1", "--wire", "depth"])
    assert not (tmp / "logs" / "exp" / "augment_depth" / "last.pt").exists()


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_trains_in_bf16_checkpoints_resumes_and_evaluates(common, steps_taken,
                                                              monkeypatch, name):
    """--mixed_precision 1 (JAX's bf16 compute, float32 master weights):
    every training step runs the model on bf16 copies of the params, the
    losses are finite float32, the checkpoints hold float32, a relaunch
    resumes at step 2 and --eval_only evaluates (in float32)."""
    from act3d_tpu_torch.train import flagship

    tmp, args = common
    main, widths = CLIS[name]
    argv = args + widths + ["--run_log_dir", f"{name}_bf16", "--mixed_precision", "1"]
    log_dir = tmp / "logs" / "exp" / f"{name}_bf16"
    casts = []
    cast_params = flagship.cast_params
    monkeypatch.setattr(flagship, "cast_params",
                        lambda model, dtype: casts.append(dtype) or cast_params(model, dtype))

    out = main.main(argv + ["--train_iters", "2"])
    assert [s for s, _ in steps_taken] == [0, 1] and casts == [torch.bfloat16] * 2
    assert all(math.isfinite(loss) for _, loss in steps_taken)
    (evaluation,) = out["evals"]
    key = "mean/pos_l2_final" if name == "keypose" else "traj_action_mse"
    assert math.isfinite(evaluation["val"][key]), evaluation
    assert json.loads((log_dir / "hparams.json").read_text())["mixed_precision"] == 1
    last = torch.load(log_dir / "last.pt", weights_only=True)
    assert last["step"] == 2 and all(
        v.dtype == torch.float32 for v in last["model"].values() if v.is_floating_point())

    out = main.main(argv + ["--train_iters", "3"])
    assert [s for s, _ in steps_taken[2:]] == [2] and len(casts) == 3 and not out["evals"]
    metrics = main.main(argv + ["--train_iters", "3", "--eval_only", "1"])
    assert metrics and all(math.isfinite(v) for v in metrics.values()) and len(casts) == 3


# JAX's ValueError for a mesh the one process cannot form (more devices
# than the launched ranks, an fsdp that does not divide them;
# tests/test_torch_parallel.py trains over several ranks)
REJECTED = [
    ("keypose", ["--num_devices", "2"], "num_devices", ValueError),
    ("keypose", ["--fsdp", "2"], "fsdp", ValueError),
]


@pytest.mark.parametrize("name,flags,match,error", REJECTED, ids=[r[2] for r in REJECTED])
def test_cli_rejects_what_the_port_lacks(tmp_path, name, flags, match, error):
    main, _ = CLIS[name]
    with pytest.raises(error, match=match):
        main.main(["--base_log_dir", str(tmp_path), "--device", "cpu", *flags])
    assert not any(tmp_path.iterdir())  # raised before writing anything


# (id, CLI, flags, a state_dict entry of the model the flags build, its shape)
# for each model option of JAX's CLIs
MODEL_OPTIONS = [
    ("backbone", "trajectory", ["--backbone", "resnet"],
     "prediction_head.visual.backbone.conv1.weight", (64, 3, 7, 7)),
    ("backbone_keypose", "keypose", ["--backbone", "resnet"],
     "visual.backbone.layer1_0.downsample_conv.weight", (256, 64, 1, 1)),
    ("rotation_parametrization", "keypose", ["--rotation_parametrization", "6D_from_top_ghost"],
     "gripper_state_fc2.weight", (7, 12)),
    ("rotation_parametrization_trajectory", "trajectory", ["--rotation_parametrization", "quat"],
     "prediction_head.rot_regressor_0_fc2.weight", (4, 24)),
    ("weight_tying", "keypose", ["--weight_tying", "0", "--gp_emb_tying", "0"],
     "ghost_points_embed_2", (1, 12)),
    ("approx_topk", "keypose", ["--approx_topk", "1"], "ghost_points_embed", (1, 12)),
    ("feat_scales_to_use", "trajectory", ["--feat_scales_to_use", "3"],
     "prediction_head.pos_attention_2.layer_0.cross_12.q_proj.weight", (24, 24)),
    ("attn_rounds", "trajectory", ["--attn_rounds", "2", "--feat_scales_to_use", "2"],
     "prediction_head.rot_regressor_3_fc1.weight", (24, 24)),
]


@pytest.mark.parametrize("case,name,flags,key,shape", MODEL_OPTIONS,
                         ids=[c[0] for c in MODEL_OPTIONS])
def test_cli_trains_with_each_model_option(common, steps_taken, case, name, flags, key, shape):
    """Each model option JAX's CLIs take trains 2 steps on the CPU, evaluates
    (the trajectory CLI through the sampler) and writes best.pt holding the
    model the option builds."""
    tmp, args = common
    main, widths = CLIS[name]
    out = main.main(args + widths + ["--run_log_dir", case, "--train_iters", "2", *flags])
    assert [s for s, _ in steps_taken] == [0, 1]
    assert all(math.isfinite(loss) for _, loss in steps_taken)
    (evaluation,) = out["evals"]
    assert all(math.isfinite(v) for v in evaluation["val"].values()), evaluation
    log_dir = tmp / "logs" / "exp" / case
    best = torch.load(log_dir / "best.pt", weights_only=True)["model"]
    assert tuple(best[key].shape) == shape
    hparams = json.loads((log_dir / "hparams.json").read_text())
    for flag, value in zip(flags[::2], flags[1::2]):
        assert str(hparams[flag[2:]]) == value, flag


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_without_a_card_raises_instead_of_using_the_cpu(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLIS[name][0].main(["--base_log_dir", str(tmp_path)])
