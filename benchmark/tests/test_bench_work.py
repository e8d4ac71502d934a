"""The copied work and bound arithmetic against hand counts, and the sites
derived from the configurations against chip_smoke.py's tables."""

import json
from pathlib import Path

import pytest

from benchmark import work

ROOT = Path(__file__).resolve().parents[2]
CD = json.loads((ROOT / "benchmark/configs/chained_diffuser.json").read_text())
A3 = json.loads((ROOT / "benchmark/configs/act3d.json").read_text())


def _merged(cfg, key):
    return {**cfg[key], "ncam": cfg["ncam"], "instruction_tokens": cfg["instruction_tokens"]}


def test_fwd_work_hand_count():
    # the planner's cross site, one call: 4 L S E FLOPs; q, out (L E), k, v
    # (S E) and the stats (L 2H) in float32
    assert work.fwd_work(50, 3074, 120, 8, 1, False) == (
        4 * 50 * 3074 * 120, 4 * (2 * 50 * 120 + 2 * 3074 * 120 + 2 * 50 * 8))
    # a mask adds one byte a key per row of the batch
    assert work.fwd_work(50, 50, 120, 8, 2, True)[1] == work.fwd_work(50, 50, 120, 8, 2, False)[1] + 100


def test_bwd_work_hand_count():
    assert work.bwd_work(3333, 3126, 60, 4, 16, False) == (
        100_021_996_800.0, 4 * (4 * 16 * 3333 * 60 + 4 * 16 * 3126 * 60 + 2 * 16 * 3333 * 4))


def test_tc_bound_picks_the_largest_term():
    assert work.tc_bound(3 * 165e12, 0, 0) == pytest.approx(3.0)  # 3xTF32: 495 / 3 TFLOP/s
    assert work.tc_bound(0, 132 * 16 * 1980e6, 0) == pytest.approx(1.0)
    assert work.tc_bound(0, 0, 3.35e12 * 2) == pytest.approx(2.0)


# chip_smoke.py's SHAPES (keystep), KEYPOSE_SHAPES and TRAIN_SHAPES (per
# training step): (site, L, S, E, H, masked, calls)
SHAPES = [("act3d.vis_ins", 3073, 53, 60, 4, False, 6),
          ("act3d.ghost_point", 3333, 3126, 60, 4, False, 6),
          ("act3d.query", 1, 3126, 60, 4, False, 6),
          ("planner.vl", 3072, 53, 120, 8, False, 200),
          ("planner.traj_lang", 50, 53, 120, 8, False, 100),
          ("planner.cross", 50, 3074, 120, 8, False, 800),
          ("planner.self", 50, 50, 120, 8, True, 800)]
KEYPOSE_SHAPES = [(3073, 53, 6), (333, 3126, 6), (1, 3126, 6)]
TRAIN_SHAPES = [(3072, 53, 2), (50, 53, 1), (50, 3074, 8), (50, 50, 8)]


def test_keystep_sites_equal_chip_smoke_tables():
    sites = (work.act3d_sites(_merged(CD, "act3d"), 1, training=False)
             + work.planner_sites(_merged(CD, "planner"), 1, per_denoise=100))
    assert [(s.name, s.l, s.s, s.e, s.h, s.masked, s.count) for s in sites] == SHAPES
    assert sum(s.count for s in sites) == 1918  # fused_mha_fwd launches a keystep


def test_training_sites_equal_chip_smoke_tables():
    act3d = work.act3d_sites(_merged(A3, "act3d"), 16, training=True)
    assert [(s.l, s.s, s.count) for s in act3d] == KEYPOSE_SHAPES
    planner = work.planner_sites(_merged(CD, "planner"), 22)
    assert [(s.l, s.s, s.count) for s in planner] == TRAIN_SHAPES
    assert all(s.b == 22 for s in planner)


def test_bounds_equal_perf_md():
    """PERF.md section 6's tensor-core bounds: 1.031 ms a keystep; 0.234 /
    0.5382 ms a batch-16 Act3D step forward / backward; 0.1495 / 0.2969 ms
    a batch-16 ChainedDiffuser step."""
    keystep = (work.act3d_sites(_merged(CD, "act3d"), 1, False)
               + work.planner_sites(_merged(CD, "planner"), 1, 100))
    assert work.bound_s(keystep) * 1e3 == pytest.approx(1.031, abs=5e-4)
    act3d = work.act3d_sites(_merged(A3, "act3d"), 16, True)
    assert work.bound_s(act3d) * 1e3 == pytest.approx(0.234, abs=5e-4)
    assert work.bound_s(act3d, backward=True) * 1e3 == pytest.approx(0.5382, abs=5e-5)
    planner = work.planner_sites(_merged(CD, "planner"), 16)
    assert work.bound_s(planner) * 1e3 == pytest.approx(0.1495, abs=5e-5)
    assert work.bound_s(planner, backward=True) * 1e3 == pytest.approx(0.2969, abs=5e-5)
