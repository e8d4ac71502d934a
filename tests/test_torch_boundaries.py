"""Boundaries of the PyTorch port.

* ``act3d_tpu_torch`` (every submodule) and ``chip_smoke.py`` import with
  ``jax`` made unimportable, and load nothing of ``act3d_tpu``.
* The entry points run on the card by default: without one they raise
  instead of drifting to the CPU, and ``chip_smoke.py`` exits non-zero
  without printing a result.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["flax"] = None
import act3d_tpu_torch
names = [m.name for m in pkgutil.walk_packages(act3d_tpu_torch.__path__, "act3d_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m == "act3d_tpu" or m.startswith("act3d_tpu."))
assert not leaked, leaked
print(len(names), "modules")
"""


def _run(args, cwd, **kw):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = _run(["-c", _IMPORT_ALL], REPO)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 15


def test_entry_points_without_a_device_raise_here():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from act3d_tpu_torch.eval.actioner import Actioner
    from act3d_tpu_torch.models import Act3D, DiffusionPlanner

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Actioner(predict_keypose=False, predict_trajectory=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Act3D(image_size=(64, 64), embedding_dim=12, num_sampling_level=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffusionPlanner(image_size=(64, 64), embedding_dim=24)


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run([str(REPO / "chip_smoke.py")], REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
