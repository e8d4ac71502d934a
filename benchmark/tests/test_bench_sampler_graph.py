"""The reader of ``sampler_graph_share.keystep``: the port's counts of
denoising steps replayed from a CUDA graph and run eagerly
(``compute_trajectory.replayed_steps`` / ``.eager_steps``).  It returns
None where the program keeps no such counts, as a program without the
sampler's graphs does, and where no step ran."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

from tiny import run_tiny, tiny_root

READER = Path(__file__).resolve().parents[1] / "metrics" / "sampler_graph_share.keystep.py"
RUN = SimpleNamespace(layer={}, traced=None)


def _read():
    spec = importlib.util.spec_from_file_location("reader_sampler_graph_share", READER)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_sampler_graph_share_reads_the_step_counters(monkeypatch):
    from act3d_tpu_torch.models.diffusion_planner import compute_trajectory

    read = _read()
    monkeypatch.setattr(compute_trajectory, "replayed_steps", 299, raising=False)
    monkeypatch.setattr(compute_trajectory, "eager_steps", 1, raising=False)
    assert read(RUN) == pytest.approx(100.0 * 299 / 300)
    monkeypatch.setattr(compute_trajectory, "replayed_steps", 0)
    monkeypatch.setattr(compute_trajectory, "eager_steps", 0)
    assert read(RUN) is None  # no step ran
    monkeypatch.setattr(compute_trajectory, "eager_steps", 500)
    assert read(RUN) == 0.0
    monkeypatch.delattr(compute_trajectory, "replayed_steps")
    assert read(RUN) is None  # a program without the counts
    monkeypatch.setattr(compute_trajectory, "replayed_steps", 5, raising=False)
    monkeypatch.delattr(compute_trajectory, "eager_steps")
    assert read(RUN) is None


@pytest.mark.parametrize("workload", ["tiny.keystep", "tiny.train"])
def test_traced_run_reports_the_share_in_the_keystep_cell(tmp_path, workload):
    """On the CPU every denoising step runs eagerly, so the keystep cell
    reads a share of 0; the training cell lists no such metric."""
    rc, result = run_tiny(tiny_root(tmp_path), workload, trace=1)
    assert rc == 0 and result["correct"], result
    if workload == "tiny.keystep":
        assert result["metrics"]["sampler_graph_share.keystep"]["value"] == 0.0
    else:
        assert "sampler_graph_share.keystep" not in result["metrics"]
