"""The multi-scale planner configuration (``chained_diffuser_ms``: adapter
``benchmark/adapters/planner_ms.py``, reference
``benchmark/reference/planner_ms.py``) at test widths on the CPU.

The reference follows the system's recorded trajectory-nearest selections
and then agrees with it; its own selections equal the system's; a planted
wrong selection reads a choice gap over the limit; the adapter lists the
6-block head's sites as ``chip_smoke.py``'s tables do; a tiny cell of the
configuration runs ``correct`` with no existing benchmark file edited; a
system whose head has no selection submodule is refused before any step."""

import json
import math
from pathlib import Path

import pytest
import torch

from benchmark import models
from benchmark.adapters import planner, planner_ms
from benchmark.drivers import train
from benchmark.faults import FAULTS
from benchmark.reference import planner_ms as reference_ms
from benchmark.reference.layers import Generators
from test_bench_adapters import _refuse_steps
from test_bench_extend import _add_cell, _copy, _edited, _run
from tiny import LIMITS, REPO, run_tiny, tiny_config, tiny_root

LENGTH = 8
CELL = "tiny_ms.train"


def tiny_ms_config() -> dict:
    """chained_diffuser_ms.json at the test widths of ``tiny_config``."""
    cfg = json.loads((REPO / "benchmark/configs/chained_diffuser_ms.json").read_text())
    cfg.update(ncam=2, image_size=64)
    cfg["planner"].update(embedding_dim=24, num_query_cross_attn_layers=3,
                          diffusion_timesteps=5, trajectory_length=LENGTH)
    return cfg


def _add_ms_cell(root: Path):
    """The tiny configuration, its traffic (train_ms_b22.json at batch 2
    under the test-size limits) and cell, beside ``tiny.train``."""
    bench = root / "benchmark"
    (bench / "configs/tiny_ms.json").write_text(json.dumps(tiny_ms_config()))
    tr = json.loads((REPO / "benchmark/traffic/train_ms_b22.json").read_text())
    tr.update(batch=2, trace_steps=2)
    tr["limits"] = {k: LIMITS[k] for k in tr["limits"]}
    (bench / "traffic/tiny_ms_train.json").write_text(json.dumps(tr))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append(dict(man["configs"][0], name="tiny_ms",
                               file="benchmark/configs/tiny_ms.json"))
    _add_cell(man, CELL, "tiny_ms", "tiny_ms_train")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


@pytest.fixture(scope="module")
def pair():
    """The system and the reference on one seeded state dict, a batch, and
    the system's training loss with the selections its forward recorded."""
    from act3d_tpu_torch.nn.dropout import Generators as ProgGenerators

    cfg = tiny_ms_config()
    adapter = models.adapter(cfg, "planner")
    batch = train.make_batches(cfg, {"batch": 2, "batch_pool": 1}, 11, "cpu")[0]
    prog = adapter.program(cfg, 11, "cpu").train()
    ref = adapter.reference(cfg, 11, "cpu").train()
    with adapter.recorder(prog) as recorded:
        loss, _ = adapter.loss_fn(prog)(batch, ProgGenerators.from_seed(5, "cpu"))
    return adapter, batch, prog, ref, loss, recorded


def test_state_dict_layouts_match(pair):
    _, _, prog, ref, _, _ = pair
    assert list(prog.state_dict()) == list(ref.state_dict())
    assert "prediction_head.rot_regressor_5_fc2.weight" in ref.state_dict()


def test_reference_follows_the_recorded_selections(pair):
    """One entry a forward, the four selections in block order; the
    reference handed them reads a choice gap of 0 and the system's loss and
    gradients.  Tolerances: the same float32 arithmetic in another order of
    operations on the CPU: on the loss 1e-6 absolute and 1e-5 relative, as
    the one-block planner's case of test_bench_reference.py; on a gradient
    1e-4 relative and 1e-6 absolute times the leaf's largest entry (at
    least 1), since the six blocks' summed loss gives gradients up to ~25
    here, and an entry whose terms nearly cancel keeps the rounding of its
    largest terms (~1e-5 at float32)."""
    adapter, batch, prog, ref, loss, recorded = pair
    assert len(recorded) == 1
    k1, k2 = 64 * LENGTH, 16 * LENGTH
    assert [tuple(idx.shape) for idx in recorded[0]] == [(2, k1), (2, k2)] * 2
    want, chosen, gap = adapter.reference_loss(ref, batch, Generators.from_seed(5, "cpu"),
                                               follow=recorded[0])
    assert gap == 0.0 and all(a is b for a, b in zip(chosen, recorded[0]))
    torch.testing.assert_close(loss, want, atol=1e-6, rtol=1e-5)
    loss.backward()
    want.backward()
    grads = dict(ref.named_parameters())
    checked = 0
    for name, p in prog.named_parameters():
        if p.grad is not None:
            want_grad = grads[name].grad
            torch.testing.assert_close(p.grad, want_grad, rtol=1e-4,
                                       atol=1e-6 * max(1.0, float(want_grad.abs().max())))
            checked += 1
    # every block's stacks, and the FPN's res1 output through the gathers
    assert checked > 300
    assert any("layer_res1" in n and p.grad is not None and p.grad.abs().sum() > 0
               for n, p in prog.named_parameters())


def test_own_selections_equal_the_systems(pair):
    adapter, batch, _, ref, _, recorded = pair
    with torch.no_grad():
        _, chosen, gap = adapter.reference_loss(ref, batch, Generators.from_seed(5, "cpu"))
    assert gap == 0.0 and len(chosen) == 4
    for own, system in zip(chosen, recorded[0]):
        assert torch.equal(own, system)


def test_a_planted_wrong_selection_is_judged(pair, monkeypatch):
    """The first selection's k-th kept point swapped for the (k+1)-th
    nearest: in a reference model's first forward the reference gathers the
    planted points and reads their distance beyond its k-th over the k-th,
    over the test limit; in a later forward (after AdamW's first step) it
    follows them unjudged, but reads inf for a selection that is not k
    points of the cloud."""
    adapter, batch, _, _, _, recorded = pair
    cfg = tiny_ms_config()
    seen = []
    distance = reference_ms.nearest_sq_distance
    monkeypatch.setattr(reference_ms, "nearest_sq_distance",
                        lambda *args: seen.append(distance(*args)) or seen[-1])
    k = 64 * LENGTH
    with torch.no_grad():
        adapter.reference_loss(adapter.reference(cfg, 11, "cpu").train(), batch,
                               Generators.from_seed(5, "cpu"), follow=recorded[0])
        m = seen[0]
        order = torch.sort(m, dim=-1, stable=True).indices
        planted = [idx.clone() for idx in recorded[0]]
        planted[0][:, k - 1] = order[:, k]
        ref = adapter.reference(cfg, 11, "cpu").train()
        _, chosen, gap = adapter.reference_loss(ref, batch, Generators.from_seed(5, "cpu"),
                                                follow=planted)
        later = adapter.reference_loss(ref, batch, Generators.from_seed(5, "cpu"),
                                       follow=planted)[2]
        planted[1][:, 0] = planted[1][:, 1]  # a point kept twice
        broken = adapter.reference_loss(ref, batch, Generators.from_seed(5, "cpu"),
                                        follow=planted)[2]
    assert chosen[0] is planted[0]
    kth, next_ = m.gather(1, order[:, k - 1:k + 1]).unbind(-1)
    assert gap == pytest.approx(float(((next_ - kth) / kth).amax()), rel=1e-6)
    assert gap > LIMITS["choice_gap"], gap
    assert later == 0.0 and broken == math.inf


@pytest.mark.parametrize("case", ["rows", "duplicate", "range"])
def test_a_selection_that_is_not_k_points_reads_inf(case):
    m = torch.rand(2, 40, generator=torch.Generator().manual_seed(0))
    idx = reference_ms.nearest(m, 8)
    assert reference_ms.choice_gap(m, idx, 8) == 0.0
    bad = {"rows": idx[:1], "duplicate": torch.cat([idx[:, :7], idx[:, :1]], dim=1),
           "range": torch.where(idx == idx[0, 0], 40, idx)}[case]
    assert reference_ms.choice_gap(m, bad, 8) == math.inf


def test_sites_equal_chip_smoke_tables():
    """At B = 16: chip_smoke.py's TRAIN_SHAPES sites at their counts in the
    6 blocks (OPTION_SCALE0_BLOCKS) and its OPTION_SHAPES sites, 114 calls
    a forward."""
    import chip_smoke

    cfg = json.loads((REPO / "benchmark/configs/chained_diffuser_ms.json").read_text())
    sites = planner_ms.sites(cfg, 16, training=True)
    got = sorted((s.l, s.s, s.masked, s.count) for s in sites)
    want = [(l, s, mask is not None, n * chip_smoke.OPTION_SCALE0_BLOCKS[site])
            for site, l, s, mask, _, n in chip_smoke.TRAIN_SHAPES
            if site in chip_smoke.OPTION_SCALE0_BLOCKS]
    want += [(l, s, mask is not None, n) for _, l, s, mask, _, n in chip_smoke.OPTION_SHAPES if n]
    assert got == sorted(want)
    assert sum(s.count for s in sites) == 114
    assert all((s.b, s.e, s.h) == (16, 120, 8) for s in sites)
    assert planner_ms.noise_width(cfg) == 9


def test_new_cell_runs_correct_with_no_file_edited(tmp_path):
    before = _copy(tmp_path)
    _add_ms_cell(tmp_path)
    _, result = _run(tmp_path, CELL, trace=1)
    assert result["correct"], result
    assert result["metrics"]["knn_per_denoise.train"]["value"] == 4.0
    assert "knn_select_ms.train" not in result["metrics"]  # no device kernels on the CPU
    # the same float32 arithmetic: rounding-level gaps, the selections followed exactly
    checks = {name: c["value"] for name, c in result["checks"].items()}
    assert set(checks) == {"choice_gap", "loss_gap", "grad_gap", "change_gap_median"}
    assert checks["choice_gap"] == 0.0 and checks["loss_gap"] < 1e-6, checks
    assert _edited(tmp_path, before) == []


@pytest.mark.parametrize("fault", ["half_batch", "state_unchanged"])
def test_fault_is_not_correct(tmp_path, fault):
    root = _add_ms_cell(tiny_root(tmp_path))
    with FAULTS[fault]():
        rc, result = run_tiny(root, CELL)
    assert rc == 0 and result["correct"] is False, result


def test_a_head_without_the_selection_submodule_is_refused(tmp_path, monkeypatch):
    """The recorder raises at once naming the submodule; a run on a system
    whose head has none (as before the submodule) fails before any step."""
    with pytest.raises(RuntimeError, match="traj_neighbours"):
        with planner_ms.recorder(planner.program(tiny_config(), 1, "cpu")):
            pass
    from act3d_tpu_torch.models.diffusion_head import DiffusionHead

    init = DiffusionHead.__init__

    def without(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.__dict__["_modules"].pop("traj_neighbours", None)

    monkeypatch.setattr(DiffusionHead, "__init__", without)
    _refuse_steps(monkeypatch)
    with pytest.raises(RuntimeError, match="traj_neighbours"):
        run_tiny(_add_ms_cell(tiny_root(tmp_path)), CELL)
