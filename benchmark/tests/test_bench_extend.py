"""A later change adds a configuration, a traffic mix, a per-layer metric
or a model adapter as new files and new manifest entries only: in a copy
of the benchmark, the new cell runs (and reports the new metric, or
follows the new adapter's recorded choices) with no existing file
edited."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

from tiny import tiny_root

ROOT = Path(__file__).resolve().parents[2]
METRIC = '''"""Training steps in the traced stretch (a metric added by a later change)."""


def read(run):
    return run.layer.get("steps_traced")
'''

PROBE = '''"""A planner adapter added by a later change: the shipped planner's, whose
recorder keeps one value a forward (the trajectory the forward got), and
whose reference loss requires that value as ``follow``."""

import contextlib
import sys

import torch

from . import planner
from .planner import OPTIONS, batches, loss_fn, noise_width, program, reference, sites, state


@contextlib.contextmanager
def recorder(model):
    seen = []
    hook = model.register_forward_hook(
        lambda module, args, out: seen.append(args[0].detach().clone()))
    try:
        yield seen
    finally:
        hook.remove()


def reference_loss(model, batch, gens, follow=None):
    if follow is None or not torch.equal(follow, batch["trajectory"]):
        raise RuntimeError("probe: the reference was not handed its step's recorded forward")
    print("probe: followed a recorded forward", file=sys.stderr)
    return planner.reference_loss(model, batch, gens, follow)
'''


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def _copy(tmp_path: Path):
    """A copy of the benchmark with the tiny cells, and its files' digests."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    tiny_root(tmp_path)
    return _digests(tmp_path)


def _run(tmp_path: Path, workload: str, trace: int):
    """The cell run from the copy in a fresh process: (stderr, result)."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from benchmark import run\n"
            "sys.exit(run.main(['--workload', %r, '--seed', '77', "
            "'--seconds', '1', '--trace', %r], device='cpu'))\n") % (
                str(tmp_path), str(ROOT), workload, str(trace))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stderr, json.loads(out.stdout.strip().splitlines()[-1])


def _edited(tmp_path: Path, before):
    after = _digests(tmp_path)
    return [p for p, d in before.items() if after[p] != d and p != Path("BENCHMARK.json")]


def _add_cell(man, name, config, traffic, like="tiny.train"):
    """A cell beside ``like`` that reports the metrics ``like`` reports."""
    man["workloads"].append(dict(next(w for w in man["workloads"] if w["name"] == like),
                                 name=name, config=config, traffic=traffic))
    for m in man["end_to_end"] + man["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(name)


def test_new_cell_and_metric_need_no_edit(tmp_path):
    before = _copy(tmp_path)

    bench = tmp_path / "benchmark"
    cfg = json.loads((bench / "configs/tiny.json").read_text())
    cfg.update(name="tiny_act3d", train_model="act3d")
    (bench / "configs/tiny_act3d.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic/tiny_train.json").read_text())
    traffic["batch"] = 3
    (bench / "traffic/tiny_train_b3.json").write_text(json.dumps(traffic))
    (bench / "metrics/steps_traced.train.py").write_text(METRIC)
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append(dict(man["configs"][0], name="tiny_act3d",
                               file="benchmark/configs/tiny_act3d.json"))
    _add_cell(man, "tiny_act3d.train_b3", "tiny_act3d", "tiny_train_b3")
    man["per_layer"].append({"name": "steps_traced.train", "unit": "steps", "better": "higher",
                             "source": "program_counter", "layer": "train/engine.py Trainer.step",
                             "moves": "train_samples_per_s",
                             "workloads": ["tiny_act3d.train_b3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    _, result = _run(tmp_path, "tiny_act3d.train_b3", trace=1)
    assert result["correct"] and result["metrics"]["steps_traced.train"]["value"] == 2
    assert _edited(tmp_path, before) == []


def test_new_adapter_needs_no_edit(tmp_path):
    """A configuration names a new planner adapter; the training driver
    hands the reference each checked step's recorded choice as ``follow``."""
    before = _copy(tmp_path)
    bench = tmp_path / "benchmark"
    (bench / "adapters/planner_probe.py").write_text(PROBE)
    cfg = json.loads((bench / "configs/tiny.json").read_text())
    cfg.update(name="tiny_probe", adapters={"planner": "planner_probe"})
    (bench / "configs/tiny_probe.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic/tiny_train.json").read_text())
    traffic["batch"] = 3
    (bench / "traffic/tiny_train_probe.json").write_text(json.dumps(traffic))
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append(dict(man["configs"][0], name="tiny_probe",
                               file="benchmark/configs/tiny_probe.json"))
    _add_cell(man, "tiny_probe.train", "tiny_probe", "tiny_train_probe")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    stderr, result = _run(tmp_path, "tiny_probe.train", trace=0)
    assert result["correct"], result
    assert stderr.count("probe: followed a recorded forward") == traffic["check_steps"]
    assert _edited(tmp_path, before) == []
