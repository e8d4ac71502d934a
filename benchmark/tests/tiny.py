"""A checkout at test size: the shipped manifest, configurations and
traffic files cut to widths and counts a CPU test holds (cell
``tiny.keystep`` on the keystep driver, ``tiny.train`` on the training
driver), written into a temporary root beside a copy of nothing else.
The run reads the configuration and traffic from that root and the
drivers, references and metric readers from this checkout."""

import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
# limits at test size: a sound run reads ~1e-7 (losses, actions, medians)
# to ~1e-2 (the worst leaf's change); the faults read 1e-2 and more
LIMITS = {"choice_gap": 1e-4, "action_gap": 1e-4, "trajectory_gap": 1e-4, "loss_gap": 1e-4,
          "grad_gap": 1e-3, "grad_gap_median": 1e-4, "change_gap": 0.2, "change_gap_median": 1e-3}


def tiny_config(train_model: str = "planner") -> dict:
    """The chained_diffuser configuration at test widths and counts."""
    cfg = json.loads((REPO / "benchmark/configs/chained_diffuser.json").read_text())
    cfg.update(ncam=2, image_size=64, train_model=train_model)
    cfg["act3d"].update(embedding_dim=24, num_ghost_points=30, num_ghost_points_val=60)
    cfg["planner"].update(embedding_dim=24, num_query_cross_attn_layers=3,
                          diffusion_timesteps=5, trajectory_length=8)
    return cfg


def tiny_root(tmp: Path, train_model: str = "planner") -> Path:
    (tmp / "benchmark" / "configs").mkdir(parents=True, exist_ok=True)
    (tmp / "benchmark" / "traffic").mkdir(parents=True, exist_ok=True)
    (tmp / "benchmark/configs/tiny.json").write_text(json.dumps(tiny_config(train_model)))
    ks = json.loads((REPO / "benchmark/traffic/keystep_closed_loop.json").read_text())
    ks.update(observation_pool=3, instruction_bank=2, episode_keysteps=2, input_sets=3,
              check_keysteps=2)
    ks["limits"] = {k: LIMITS[k] for k in ks["limits"]}
    (tmp / "benchmark/traffic/tiny_keystep.json").write_text(json.dumps(ks))
    tr = json.loads((REPO / "benchmark/traffic/train_b16.json").read_text())
    tr.update(batch=2, trace_steps=2)
    tr["limits"] = {k: LIMITS[k] for k in tr["limits"]}
    (tmp / "benchmark/traffic/tiny_train.json").write_text(json.dumps(tr))
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    man["configs"] = [dict(man["configs"][0], name="tiny", file="benchmark/configs/tiny.json")]
    keystep = next(w for w in man["workloads"] if w["traffic"].startswith("keystep"))
    train = next(w for w in man["workloads"] if w["traffic"].startswith("train"))
    man["workloads"] = [dict(keystep, name="tiny.keystep", config="tiny", traffic="tiny_keystep"),
                        dict(train, name="tiny.train", config="tiny", traffic="tiny_train")]
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({"tiny.keystep" if w.endswith("keystep") else "tiny.train"
                                     for w in m["workloads"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    return tmp


def run_tiny(tmp: Path, workload: str, seed: int = 3000000017, trace: int = 0,
             seconds: float = 1.0, device: str = "cpu"):
    """One run, on the CPU unless ``device`` is "cuda" (the look for a card
    skipped on the CPU): (rc, result)."""
    import contextlib
    import io

    from benchmark import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], root=tmp, device=device)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
