"""The reader of ``train_graph_share.train``: the port's counts of training
steps replayed from a CUDA graph and run eagerly
(``Trainer.replayed_steps`` / ``.eager_steps``).  It returns None where
the program keeps no such counts, as a program without the step's graphs
does, and where no step ran."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

from tiny import run_tiny, tiny_root

READER = Path(__file__).resolve().parents[1] / "metrics" / "train_graph_share.train.py"
RUN = SimpleNamespace(layer={}, traced=None)


def _read():
    spec = importlib.util.spec_from_file_location("reader_train_graph_share", READER)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_train_graph_share_reads_the_step_counters(monkeypatch):
    from act3d_tpu_torch.train.engine import Trainer

    read = _read()
    monkeypatch.setattr(Trainer, "replayed_steps", 196, raising=False)
    monkeypatch.setattr(Trainer, "eager_steps", 4, raising=False)
    assert read(RUN) == pytest.approx(98.0)
    monkeypatch.setattr(Trainer, "replayed_steps", 0)
    monkeypatch.setattr(Trainer, "eager_steps", 0)
    assert read(RUN) is None  # no step ran
    monkeypatch.setattr(Trainer, "eager_steps", 7)
    assert read(RUN) == 0.0
    monkeypatch.delattr(Trainer, "replayed_steps")
    assert read(RUN) is None  # a program without the counts
    monkeypatch.setattr(Trainer, "replayed_steps", 5, raising=False)
    monkeypatch.delattr(Trainer, "eager_steps")
    assert read(RUN) is None


@pytest.mark.parametrize("workload", ["tiny.keystep", "tiny.train"])
def test_traced_run_reports_the_share_in_the_training_cell(tmp_path, workload):
    """On the CPU every training step runs eagerly, so the training cell
    reads a share of 0; the keystep cell lists no such metric."""
    rc, result = run_tiny(tiny_root(tmp_path), workload, trace=1)
    assert rc == 0 and result["correct"], result
    if workload == "tiny.train":
        assert result["metrics"]["train_graph_share.train"]["value"] == 0.0
    else:
        assert "train_graph_share.train" not in result["metrics"]
