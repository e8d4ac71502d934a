"""The control on the card, at test size: the reference put in the
system's place in TF32 (the precision below the configurations' float32)
comes out not correct, while the system's own run on the card comes out
correct, under the test-size limits.  At the cells' own sizes the control
is read by ``benchmark/calibrate.py --control`` (PERF.md gives the
readings)."""

from types import SimpleNamespace

import pytest

from benchmark import harness
from tiny import LIMITS, run_tiny, tiny_root


@pytest.mark.gpu
@pytest.mark.parametrize("workload,model", [("tiny.keystep", "planner"),
                                            ("tiny.train", "planner"), ("tiny.train", "act3d")])
def test_tf32_control_is_not_correct(tmp_path, card, workload, model):
    root = tiny_root(tmp_path, model)
    rc, result = run_tiny(root, workload, device=card)
    assert rc == 0 and result["correct"], result
    cell = harness.Cell(root, workload)
    ctx = SimpleNamespace(config=cell.config, traffic=cell.traffic, seed=3000000019,
                          device=card)
    readings = harness.driver(cell.traffic["driver"]).control(ctx)
    assert any(readings[name] > LIMITS[name] for name in cell.traffic["limits"]), readings
