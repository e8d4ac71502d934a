"""Boundaries of the PyTorch port.

* ``act3d_tpu_torch`` (every submodule) and ``chip_smoke.py`` import with
  ``jax``, ``flax`` and ``msgpack`` made unimportable (the ``.msgpack``
  reader, ``core/msgpack.py``, is the port's own), and load nothing of
  ``act3d_tpu``; the eval
  CLI and the RLBench loop also import without OpenCV, RLBench and PyRep,
  which the card's machine lacks; every module imports without matplotlib
  and tensorboard (the host path's viz and logger import them inside
  functions), and a CLI asked for ``--use_tensorboard 1`` without
  tensorboard raises ImportError before it writes anything; the
  preprocessing tools and the profiler import without ``transformers``,
  PIL, RLBench and PyRep.
* The entry points run on the card by default: without one they raise
  instead of drifting to the CPU (``preprocess_instructions`` too, with
  ``--device cuda`` or no ``--device``), and ``chip_smoke.py`` exits
  non-zero without printing a result.
* No module under ``act3d_tpu_torch/train/`` imports
  ``models/sampler_graph.py``: the graph mechanics both share live in
  ``utils/graphs.py``.
"""

import ast
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
sys.modules["msgpack"] = None  # the .msgpack reader is the port's own
import act3d_tpu_torch
names = [m.name for m in pkgutil.walk_packages(act3d_tpu_torch.__path__, "act3d_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert "act3d_tpu_torch.core.msgpack" in names
leaked = sorted(m for m in sys.modules if m == "act3d_tpu" or m.startswith("act3d_tpu."))
assert not leaked, leaked
print(len(names), "modules")
"""


_IMPORT_EVAL = r"""
import sys
for name in ("jax", "flax", "cv2", "rlbench", "pyrep"):
    sys.modules[name] = None  # any import of these now raises ImportError
import act3d_tpu_torch.eval.main
from act3d_tpu_torch.eval import rlbench_env
assert not rlbench_env.HAS_RLBENCH
print("ok")
"""


_IMPORT_WITHOUT_PLOTS = r"""
import importlib, pkgutil, sys, tempfile
from pathlib import Path
for name in ("jax", "flax", "matplotlib", "tensorboard", "PIL"):
    sys.modules[name] = None  # any import of these now raises ImportError
import act3d_tpu_torch
names = [m.name for m in pkgutil.walk_packages(act3d_tpu_torch.__path__, "act3d_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
for name in ("data.compact", "data.depthwire", "data.device_augment", "data.pipeline",
             "train.viz"):
    assert "act3d_tpu_torch." + name in names, name
assert "torch.utils.tensorboard" not in sys.modules
from act3d_tpu_torch.train import main_keypose
tmp = Path(tempfile.mkdtemp())
try:
    main_keypose.main(["--base_log_dir", str(tmp), "--device", "cpu", "--use_tensorboard", "1"])
except ImportError as e:
    assert "tensorboard" in str(e), e
else:
    raise AssertionError("no ImportError")
assert not any(tmp.iterdir())
print("ok")
"""


_IMPORT_PREPROCESSING = r"""
import importlib, pkgutil, sys
for name in ("jax", "flax", "transformers", "PIL", "rlbench", "pyrep"):
    sys.modules[name] = None  # any import of these now raises ImportError
import act3d_tpu_torch.preprocessing as pre
names = [m.name for m in pkgutil.walk_packages(pre.__path__, "act3d_tpu_torch.preprocessing.")]
for name in names + ["act3d_tpu_torch.train.profiling"]:
    importlib.import_module(name)
assert len(names) == 5, names
from act3d_tpu_torch.eval import rlbench_env
assert not rlbench_env.HAS_RLBENCH
leaked = sorted(m for m in sys.modules if m == "act3d_tpu" or m.startswith("act3d_tpu."))
assert not leaked, leaked
print("ok")
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


def test_host_path_imports_plots_and_tensorboard_only_inside_functions():
    proc = _run(["-c", _IMPORT_WITHOUT_PLOTS], REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok"]


def test_eval_cli_imports_without_opencv_or_the_simulator():
    proc = _run(["-c", _IMPORT_EVAL], REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok"]


def test_preprocessing_and_profiling_import_without_transformers_pil_or_the_simulator():
    proc = _run(["-c", _IMPORT_PREPROCESSING], REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok"]


@pytest.mark.parametrize("device", [["--device", "cuda"], []])
def test_preprocess_instructions_without_a_device_raises_here(tmp_path, device):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from act3d_tpu_torch.preprocessing import preprocess_instructions

    ann = tmp_path / "annotations.json"
    ann.write_text('[{"task": "pick_and_lift", "variation": 0, "instructions": ["pick"]}]')

    def tokenizer(texts, padding):  # never reached
        raise AssertionError("the encoder ran without a card")

    out = tmp_path / "instructions.pkl"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preprocess_instructions.main(["--tasks", "pick_and_lift", "--annotations", str(ann),
                                      "--output", str(out)] + device,
                                     tokenizer=tokenizer, model=torch.nn.Identity())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preprocess_instructions.encode_instructions(["pick"], tokenizer=tokenizer,
                                                    model=torch.nn.Identity())
    assert not out.exists()


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


def _imported(path: Path, package: str):
    """The modules ``path`` (a module of ``package``) names in its imports,
    relative ones resolved."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            parts = package.split(".")
            base = ".".join(parts[:len(parts) - node.level + 1] if node.level else [])
            module = ".".join(x for x in (base, node.module) if x)
            yield module
            yield from (f"{module}.{alias.name}" for alias in node.names)


def test_training_modules_do_not_import_the_sampler_graph():
    offenders = [path.name for path in sorted((REPO / "act3d_tpu_torch" / "train").glob("*.py"))
                 if "act3d_tpu_torch.models.sampler_graph" in
                 _imported(path, "act3d_tpu_torch.train")]
    assert not offenders, offenders
