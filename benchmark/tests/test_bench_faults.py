"""The check catches a broken timed path: a whole run at test size on the
CPU (the look for a card skipped), with one fault planted in the system,
comes out not correct; the sound run comes out correct.  One fault each
of those the cells can have: an answer altered where it is produced
(keystep), a step that leaves the state unchanged (from the first step,
or only once the set-up's warm-up has run), half of the batch left out
with the mean over the rest (training).  No cell runs over several
chips, so none can leave out an exchange between them."""

import pytest

from benchmark.faults import FAULTS
from tiny import run_tiny, tiny_root


CASES = [("tiny.keystep", "planner", "altered_trajectory"),
         ("tiny.train", "planner", "state_unchanged"),
         ("tiny.train", "act3d", "state_unchanged"),
         ("tiny.train", "planner", "state_unchanged_after_warmup"),
         ("tiny.train", "act3d", "state_unchanged_after_warmup"),
         ("tiny.train", "planner", "half_batch"),
         ("tiny.train", "act3d", "half_batch")]


@pytest.mark.parametrize("workload,model,fault", CASES, ids=["-".join(c) for c in CASES])
def test_fault_is_not_correct(tmp_path, workload, model, fault):
    with FAULTS[fault]():
        rc, result = run_tiny(tiny_root(tmp_path, model), workload)
    assert rc == 0 and result["correct"] is False, result


@pytest.mark.parametrize("workload,model", [("tiny.keystep", "planner"),
                                            ("tiny.train", "planner"), ("tiny.train", "act3d")])
def test_sound_run_is_correct(tmp_path, workload, model):
    rc, result = run_tiny(tiny_root(tmp_path, model), workload)
    assert rc == 0 and result["correct"], result
