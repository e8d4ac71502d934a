"""The port's training CLIs on the CPU.

Both ``main()`` run with ``--device cpu`` over a fixture tree written by
the port's own fixture writer, at the basic widths of
``scripts/drive_fixture_clis.py`` (128^2, one camera, emb 12 / 24, 32 ghost
points, one layer per attention stack, 5 diffusion steps, ``--train_iters 2
--val_freq 2``): finite losses, ``best.pt`` / ``last.pt`` / ``hparams.json``
/ ``metrics.jsonl``, a relaunch that resumes at step 2, ``--eval_only``,
and ``NotImplementedError`` for each kind of flag the port does not have
yet.  Without a card, the default device raises.  Nothing here imports
JAX.
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


# one flag of each kind the port rejects, with the CLI it is given to
REJECTED = [
    ("keypose", ["--num_devices", "2"], "num_devices"),
    ("keypose", ["--fsdp", "2"], "fsdp"),
    ("keypose", ["--compact_transfer", "1"], "compact_transfer"),
    ("keypose", ["--wire", "depth"], "wire"),
    ("keypose", ["--instr_mode", "ids"], "instr_mode"),
    ("keypose", ["--device_augment", "1"], "device_augment"),
    ("keypose", ["--num_workers", "2"], "num_workers"),
    ("trajectory", ["--mixed_precision", "1"], "mixed_precision"),
    ("trajectory", ["--use_tensorboard", "1"], "use_tensorboard"),
    ("trajectory", ["--backbone", "resnet"], "backbone"),
    ("keypose", ["--rotation_parametrization", "6D"], "rotation_parametrization"),
    ("keypose", ["--weight_tying", "0"], "weight_tying"),
    ("keypose", ["--approx_topk", "1"], "approx_topk"),
    ("trajectory", ["--feat_scales_to_use", "3"], "feat_scales_to_use"),
    ("trajectory", ["--attn_rounds", "2"], "attn_rounds"),
]


@pytest.mark.parametrize("name,flags,match", REJECTED, ids=[r[2] for r in REJECTED])
def test_cli_rejects_what_the_port_lacks(tmp_path, name, flags, match):
    main, _ = CLIS[name]
    with pytest.raises(NotImplementedError, match=match):
        main.main(["--base_log_dir", str(tmp_path), "--device", "cpu", *flags])
    assert not any(tmp_path.iterdir())  # raised before writing anything


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_without_a_card_raises_instead_of_using_the_cpu(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLIS[name][0].main(["--base_log_dir", str(tmp_path)])
