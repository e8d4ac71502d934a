"""A later change adds a configuration, a traffic mix and a per-layer
metric as new files and new manifest entries only: in a copy of the
benchmark, the new cell runs and reports the new metric with no existing
file edited."""

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


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_and_metric_need_no_edit(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    tiny_root(tmp_path)
    before = _digests(tmp_path)

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
    man["workloads"].append(dict(man["workloads"][1], name="tiny_act3d.train_b3",
                                 config="tiny_act3d", traffic="tiny_train_b3"))
    for m in man["end_to_end"] + man["per_layer"]:
        if "tiny.train" in m.get("workloads", []):
            m["workloads"].append("tiny_act3d.train_b3")
    man["per_layer"].append({"name": "steps_traced.train", "unit": "steps", "better": "higher",
                             "source": "program_counter", "layer": "train/engine.py Trainer.step",
                             "moves": "train_samples_per_s",
                             "workloads": ["tiny_act3d.train_b3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from benchmark import run\n"
            "sys.exit(run.main(['--workload', 'tiny_act3d.train_b3', '--seed', '77', "
            "'--seconds', '1', '--trace', '1'], device='cpu'))\n") % (str(tmp_path), str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["metrics"]["steps_traced.train"]["value"] == 2
    after = _digests(tmp_path)
    edited = [p for p, d in before.items() if after[p] != d and p != Path("BENCHMARK.json")]
    assert edited == []
