"""What every run shares: the manifest and a cell's files, seeds derived
from the run's seed, the card's identity, the import guard, the checks
that decide ``correct``, and the per-layer metric readers.

Nothing here is specific to a configuration, a traffic mix or a metric:
those are files found by the names in ``BENCHMARK.json`` (a traffic file
names its driver in ``benchmark/drivers``; a configuration's models are
the adapters of ``benchmark/adapters``, benchmark/models.py; a per-layer
metric is ``benchmark/metrics/<name>.py``).
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "act3d_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: ``act3d_tpu_torch`` is not
    ``act3d_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def derive(seed: int, label: str) -> int:
    """A 62-bit seed for one purpose, from the run's seed (any integer)."""
    digest = hashlib.sha256(f"{seed}:{label}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**62 - 1)


@dataclass
class Check:
    """One number compared with its limit; it passes when finite and at
    most the limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """What a driver hands back: counts, end-to-end readings, the checks,
    and what the per-layer readers read (``layer``: spans and counts taken
    around the program's calls; ``traced``: the trace reading)."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: List[Check]
    memory_peak_bytes: int
    layer: Dict[str, float] = field(default_factory=dict)
    traced: Optional[object] = None


class Cell:
    """One workload of the manifest with its configuration and traffic."""

    def __init__(self, root: Path, name: str):
        manifest_path = root / "BENCHMARK.json"
        if not manifest_path.is_file():
            raise FileNotFoundError(f"no BENCHMARK.json in {root}")
        self.manifest = json.loads(manifest_path.read_text())
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = cells[name]
        self.name = name
        configs = {c["name"]: c for c in self.manifest["configs"]}
        self.config = json.loads((root / configs[self.workload["config"]]["file"]).read_text())
        traffic_dir = root / self.manifest["paths"][0] / "traffic"
        self.traffic = json.loads((traffic_dir / f"{self.workload['traffic']}.json").read_text())

    def metrics(self, section: str) -> List[dict]:
        """The manifest's end_to_end or per_layer entries this cell reports:
        those listing it, and those with no list whose end-to-end metric
        (for per_layer: the one it moves) this cell reports."""
        e2e = {m["name"] for m in self.manifest["end_to_end"]
               if self.name in m.get("workloads", [self.name])}
        out = []
        for m in self.manifest[section]:
            if "workloads" in m:
                if self.name in m["workloads"]:
                    out.append(m)
            elif section == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out


def driver(name: str):
    """The driver module a traffic file names."""
    return importlib.import_module(f"benchmark.drivers.{name}")


def read_metric(name: str, run: SimpleNamespace) -> Optional[float]:
    """``benchmark/metrics/<name>.py``'s ``read(run)``: a number, or None
    when the run holds nothing for it to read."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


class float32:
    """Float32 matmuls and cuDNN convolutions inside the block in full
    float32 (``"ieee"``) or in TF32 (``"tf32"``), set through PyTorch's
    ``fp32_precision`` API (the one the system sets; the legacy
    ``allow_tf32`` flags cannot be read once it is set), and restored."""

    def __init__(self, mode: str):
        self.mode = mode

    def __enter__(self):
        import torch

        self.saved = (torch.backends.cuda.matmul.fp32_precision,
                      torch.backends.cudnn.conv.fp32_precision)
        torch.backends.cuda.matmul.fp32_precision = self.mode
        torch.backends.cudnn.conv.fp32_precision = self.mode
        return self

    def __exit__(self, *exc):
        import torch

        torch.backends.cuda.matmul.fp32_precision = self.saved[0]
        torch.backends.cudnn.conv.fp32_precision = self.saved[1]
        return False


def device_info(chips: int) -> Dict[str, object]:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": 0}
    try:
        info["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        info["power_limit"] = "not read"
    return info


def gap(got, want) -> float:
    """Largest absolute difference of two arrays."""
    import numpy as np

    return float(np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))))


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    """The worst leaf's |norm_prog - norm_ref| over the larger of the
    reference leaf's norm and the median leaf's; ``keep`` limits the
    leaves compared."""
    import numpy as np

    med = float(np.median(list(ref.values())))
    worst = 0.0
    for n in ref:
        if keep is None or n in keep:
            diff, scale = abs(prog[n] - ref[n]), max(ref[n], med)
            worst = max(worst, diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf))
    return worst
