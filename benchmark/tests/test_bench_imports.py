"""The import guard compares whole top-level names; the reference imports
nothing of the system or of JAX; a run loads no JAX module."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("name,flagged", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("optax", True), ("act3d_tpu", True), ("act3d_tpu.models.act3d", True),
    ("act3d_tpu_torch", False), ("act3d_tpu_torch.models", False), ("jaxtyping", False),
    ("flaxen", False), ("torch", False),
])
def test_whole_top_level_names(name, flagged):
    assert bool(harness.forbidden_modules([name])) == flagged


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(harness.FORBIDDEN), tops
    if "reference" in path.parts:
        assert "act3d_tpu_torch" not in tops


def test_a_run_loads_no_jax_module(tmp_path):
    """The tiny cell run end to end on the CPU in a fresh process: nothing
    of JAX or the JAX package is loaded afterwards."""
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from tiny import tiny_root, run_tiny\n"
        "from benchmark import harness\n"
        "rc, result = run_tiny(tiny_root(Path(%r)), 'tiny.keystep')\n"
        "assert rc == 0 and result['correct'], result\n"
        "print('FORBIDDEN', harness.forbidden_modules())\n"
    ) % (str(ROOT), str(ROOT / "benchmark/tests"), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
