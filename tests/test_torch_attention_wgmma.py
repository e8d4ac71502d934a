"""The bf16 fused-MHA bodies on Hopper's wgmma (``--mixed_precision 1``).

On the CPU: the launch plans of the bf16 entries (``fwd_plan_bf16``,
``bwd_plan_bf16``) cover every query row, key and head and fill the card
at the training steps' sites; short query blocks (forward L <= 16,
backward L <= 64) and wide heads (d > 32) take the mma.sync body; every
run the bodies stage by bulk copy is 16-byte aligned and stays inside its
tensor (``bulk_cover`` below, the staging rule of
``csrc/mha_wgmma_bf16.cuh``'s act3d_run_cover); the wrappers hand the C
entries the plan and a workspace of its size, and refuse what the entries
do not take; ``launch_plans`` picks a call's plan inside its block.

On the card (``-m gpu``): the wgmma bodies against the bf16 plain versions
and the float32 plain version on the same bf16-rounded inputs, within
``bf16_errors``' bound (the gradients with the float32-noise floor), stats
at atol 2e-5 / rtol 1e-4, repeats bit-identical, at ragged L and S, every
head width they take, masks with a fully masked row, dropout with a batch
offset, and any plan:

    python -m pytest --noconftest tests/test_torch_attention_wgmma.py -m gpu
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from act3d_tpu_torch.kernels import attention
from act3d_tpu_torch.kernels.attention import (
    BwdPlan,
    FwdPlan,
    WgBwdPlan,
    WgFwdPlan,
    bwd_plan_bf16,
    fused_mha_backward_reference,
    fused_mha_forward,
    fused_mha_forward_reference,
    fwd_plan_bf16,
)

# (B, L, S, H, d) of the bf16 training steps' attention sites
STEP_SITES = [
    (16, 3073, 53, 4, 15), (16, 333, 3126, 4, 15), (16, 1, 3126, 4, 15),
    (16, 3072, 53, 8, 15), (16, 50, 53, 8, 15), (16, 50, 3074, 8, 15), (16, 50, 50, 8, 15),
    (16, 3200, 53, 8, 15), (16, 50, 3202, 8, 15), (16, 800, 53, 8, 15), (16, 50, 802, 8, 15),
]
GHOST, CROSS = (16, 333, 3126, 4, 15), (16, 50, 3074, 8, 15)


def _plan_cases():
    rng = np.random.default_rng(1)
    cases = list(STEP_SITES)
    for _ in range(300):
        cases.append((int(rng.integers(1, 20)), int(rng.integers(1, 700)),
                      int(rng.integers(1, 5000)), int(rng.choice([1, 2, 3, 4, 6, 8, 16])),
                      int(rng.integers(1, 65))))
    return cases


def _cdiv(a, b):
    return -(-a // b)


def bulk_cover(start: int, nbytes: int, lo: int, hi: int) -> tuple:
    """How the wgmma bodies stage a run of ``nbytes`` bytes at byte address
    ``start`` of a tensor spanning [lo, hi) (csrc/mha_wgmma_bf16.cuh's
    act3d_run_cover): ((s0, s1), plain) with [s0, s1) the part one bulk
    copy moves, 16-byte aligned at both ends, and ``plain`` the bytes the
    staging warp copies itself.  The run's aligned cover when it stays in
    the tensor; else its aligned middle, the ends (under 16 bytes each)
    plain."""
    end = start + nbytes
    if nbytes == 0:
        return (start, start), 0
    c0, c1 = start & ~15, (end + 15) & ~15
    if c0 >= lo and c1 <= hi:
        return (c0, c1), 0
    a0, a1 = (start + 15) & ~15, end & ~15
    if a1 <= a0:
        return (start, start), nbytes
    return (a0, a1), nbytes - (a1 - a0)


def test_bf16_forward_plan_covers_rows_keys_and_heads():
    """Query tiles of 64 rows cover L, the key chunks (multiples of the key
    tile) cover S, the head groups divide H; key records where several
    query tiles read a key tile; the workspace is what the C entry reads
    (the records, then the partials and one counter per tile and group)."""
    for b, l, s, h, d in _plan_cases():
        plan = fwd_plan_bf16(b, l, s, h, d)
        if not isinstance(plan, WgFwdPlan):
            assert isinstance(plan, FwdPlan)
            continue
        dp = 16 if d <= 16 else 32
        assert plan.group in (1, 2, 4) and h % plan.group == 0 and plan.group <= 64 // dp
        assert (plan.q_tiles - 1) * 64 < l <= plan.q_tiles * 64
        assert (plan.nsplit - 1) * plan.chunk < s <= plan.nsplit * plan.chunk
        assert plan.chunk == s or plan.chunk % attention.WG_KEYS == 0
        assert plan.blocks == plan.q_tiles * plan.nsplit * (h // plan.group) * b
        counters = plan.q_tiles * (h // plan.group) * b
        assert plan.prep == (plan.q_tiles > 1)
        want = (b * _cdiv(s, 64) * h * 2 * 64 * dp * 2 // 4) * plan.prep  # V^T and K
        want += plan.nsplit * b * l * (h * d + 2 * h) + counters if plan.nsplit > 1 else 0
        assert plan.workspace_floats == want and plan.kernels == 1 + plan.prep
        assert attention.wg_fwd_smem(h * d, dp, plan.group, plan.prep) <= 232448


def test_bf16_backward_plan_covers_rows_keys_and_heads():
    """dk/dv: 64-key tiles cover S, the row splits (multiples of 64) cover
    L; dq: 64-row tiles cover L, the key chunks cover S; head groups divide
    H; the workspace holds the row and key records of every tile, the dk/dv
    slabs and the dq partials and counters the C entry reads."""
    for b, l, s, h, d in _plan_cases():
        plan = bwd_plan_bf16(b, l, s, h, d)
        if not isinstance(plan, WgBwdPlan):
            assert isinstance(plan, BwdPlan)
            continue
        e = h * d
        for g in (plan.group, plan.dq_group):
            assert g in (1, 2, 4) and h % g == 0
        assert (plan.key_tiles - 1) * 64 < s <= plan.key_tiles * 64
        assert (plan.nsplit - 1) * plan.rows_per_split < l <= plan.nsplit * plan.rows_per_split
        assert plan.rows_per_split == l or plan.rows_per_split % 64 == 0
        assert (plan.q_tiles - 1) * 64 < l <= plan.q_tiles * 64
        assert (plan.dq_nsplit - 1) * plan.dq_chunk < s <= plan.dq_nsplit * plan.dq_chunk
        assert plan.blocks == plan.key_tiles * plan.nsplit * (h // plan.group) * b
        assert plan.dq_blocks == plan.q_tiles * plan.dq_nsplit * (h // plan.dq_group) * b
        assert plan.dkv_floats == (2 * plan.nsplit * b * s * e if plan.nsplit > 1 else 0)
        dq_base = plan.q_tiles * (h // plan.dq_group) * b
        assert plan.dq_floats == (plan.dq_nsplit * b * l * e + dq_base
                                  if plan.dq_nsplit > 1 else 0)
        dp = 16 if d <= 16 else 32
        rows = b * plan.q_tiles * h * (4 * 64 * dp * 2 + 1024)  # q, dO, qf^T, dof^T, per row
        keys = b * plan.key_tiles * h * 3 * 64 * dp * 2  # K, V, K^T
        assert plan.record_floats == (rows + keys) // 4
        assert plan.workspace_floats == plan.record_floats + plan.dkv_floats + plan.dq_floats
        assert plan.kernels == 4 + (plan.nsplit > 1)
        assert attention.wg_dkdv_smem(e, dp, plan.group) <= 232448
        assert attention.wg_dq_smem(e, h, dp, plan.dq_group) <= 232448


@pytest.mark.parametrize("site", [GHOST, CROSS])
def test_bf16_plans_fill_the_card_at_the_ghost_and_cross_sites(site):
    """At the Act3D ghost site and the ChainedDiffuser cross site every
    launch has at least 132 blocks (one per SM): the wgmma forward at both,
    the wgmma backward (both passes) at the ghost site, whose dq pass needs
    no workspace (no key split), and the mma.sync backward at the cross
    site (L = 50)."""
    fwd, bwd = fwd_plan_bf16(*site), bwd_plan_bf16(*site)
    assert isinstance(fwd, WgFwdPlan) and fwd.blocks >= 132 and bwd.blocks >= 132
    if site == GHOST:
        assert isinstance(bwd, WgBwdPlan) and bwd.dq_blocks >= 132
        assert bwd.dq_nsplit == 1 and bwd.dq_floats == 0
    else:
        assert isinstance(bwd, BwdPlan)


@pytest.mark.parametrize("l", [1, 8, 16, 17, 50, 64, 65, 333])
@pytest.mark.parametrize("d", [8, 15, 16, 17, 32, 33, 64])
def test_bf16_plans_route_short_queries_and_wide_heads_to_mma_sync(l, d):
    """The forward at L <= 16 (one row of a 64-row wgmma tile), the
    backward at L <= 64 (one row tile per key block) and both at d > 32
    take the mma.sync body with the float32 entry's plans (at the bf16
    plans' own defaults, which are the float32 ones); the rest the wgmma
    bodies."""
    fwd, bwd = fwd_plan_bf16(4, l, 300, 4, d), bwd_plan_bf16(4, l, 300, 4, d)
    assert isinstance(fwd, WgFwdPlan) == (l > 16 and d <= 32)
    assert isinstance(bwd, WgBwdPlan) == (l > 64 and d <= 32)
    if not isinstance(fwd, WgFwdPlan):
        assert fwd == attention.fwd_plan(4, l, 300, 4, d)
    if not isinstance(bwd, WgBwdPlan):
        assert bwd == attention.bwd_plan(4, l, 300, 4, d)


def _runs(plan_fwd, plan_bwd, b, l, s, h, d, base):
    """(start, bytes, lo, hi) of every run the wgmma bodies stage for one
    call whose tensors all start at byte address ``base``."""
    e = h * d
    q_hi, k_hi = base + 2 * b * l * e, base + 2 * b * s * e
    st_hi, dl_hi, m_hi = base + 8 * b * l * h, base + 4 * b * l * h, base + b * s
    out = []
    for bi in range(b):
        for t in range(plan_fwd.q_tiles):
            r0, nr = 64 * t, min(64, l - 64 * t)
            row = bi * l + r0
            out += [(base + 2 * row * e, 2 * nr * e, base, q_hi),
                    (base + 8 * row * h, 8 * nr * h, base, st_hi),
                    (base + 4 * row * h, 4 * nr * h, base, dl_hi)]
        for k0 in range(0, s, attention.WG_KEYS):  # key tiles (chunks are multiples)
            n = min(attention.WG_KEYS, s - k0)
            out += [(base + 2 * (bi * s + k0) * e, 2 * n * e, base, k_hi),
                    (base + bi * s + k0, n, base, m_hi)]
        for k0 in range(0, s, 64):  # the dk/dv pass's key tiles
            n = min(64, s - k0)
            out.append((base + 2 * (bi * s + k0) * e, 2 * n * e, base, k_hi))
        for i0 in range(0, l, 64):  # its row tiles (splits are multiples of 64)
            n = min(64, l - i0)
            out.append((base + 2 * (bi * l + i0) * e, 2 * n * e, base, q_hi))
    return out


@pytest.mark.parametrize("base_offset", [0, 2, 8])
@pytest.mark.parametrize("e,h", [(15, 1), (60, 4), (120, 8)])
def test_bulk_copies_start_16_byte_aligned(e, h, base_offset):
    """Every bulk copy of the wgmma bodies, at E = 15 (the core's 30-byte
    rows), 60 (120 bytes) and 120 (240 bytes) and for tensors that start
    on or off a 16-byte line: starts and ends on 16-byte lines, stays inside
    its tensor, lands 16-byte aligned in its stage buffer and inside it;
    what it leaves out (only at a tensor's unaligned ends) is under 16 bytes
    at each end of the run."""
    d = e // h
    b, l, s = 3, 333, 257
    base = 0x7F0000000000 + base_offset
    for start, nbytes, lo, hi in _runs(fwd_plan_bf16(b, l, s, h, d),
                                       bwd_plan_bf16(b, l, s, h, d), b, l, s, h, d, base):
        (s0, s1), plain = bulk_cover(start, nbytes, lo, hi)
        end = start + nbytes
        if s1 == s0:  # no bulk part: a run of under 32 bytes at a tensor's end
            assert plain == nbytes < 32
            continue
        assert s0 % 16 == 0 and s1 % 16 == 0 and lo <= s0 < s1 <= hi
        if plain == 0:
            assert s0 <= start and end <= s1 and s1 - s0 >= nbytes
        else:
            assert start <= s0 and s1 <= end and plain == nbytes - (s1 - s0)
            assert s0 - start < 16 and end - s1 < 16
        # byte x lands at buffer + x - (start rounded down to 16)
        land0, land1 = s0 - (start & ~15), s1 - (start & ~15)
        assert land0 % 16 == 0 and land1 <= attention._run(nbytes)
    assert bulk_cover(base, 0, base, base + 64) == ((base, base), 0)
    # the last 20 bytes of a 64-byte tensor: one bulk copy when the tensor
    # ends on a 16-byte line, else no copy past its end
    (s0, s1), plain = bulk_cover(base + 44, 20, base, base + 64)
    assert s1 <= base + 64 and (plain == 0) == (base_offset == 0)
    assert plain == 0 or plain == 20 - (s1 - s0)


def _fake_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=7))


def test_bf16_wrappers_tell_the_c_entries_their_plans(monkeypatch):
    """The bf16 launches pass the C entries the plan's body and numbers
    (group >= 1: the wgmma bodies; 0: mma.sync) and a workspace of the
    plan's size (run here with fake library functions, since there is no
    card)."""
    calls, sizes = [], []
    monkeypatch.setattr(attention, "_fwd_bf16_fn", lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(attention, "_bwd_bf16_fn", lambda: lambda *a: calls.append(a) or 0)
    workspace = attention._workspace
    monkeypatch.setattr(attention, "_workspace",
                        lambda n, dev: sizes.append(n) or workspace(n, dev))
    _fake_cuda(monkeypatch)
    bf = torch.bfloat16
    for b, l, s, h, d in [(2, 333, 3126, 4, 15), (2, 50, 3074, 8, 15), (2, 1, 300, 4, 15),
                          (2, 70, 90, 2, 40)]:
        q, k, v = (torch.zeros(b, n, h * d, dtype=bf) for n in (l, s, s))
        fp = fwd_plan_bf16(b, l, s, h, d)
        attention._launch_fwd(q, k, v, h, None, 0.1, 5, b0=3)
        args = calls[-1]
        if isinstance(fp, WgFwdPlan):
            assert args[7:18] == (b, l, s, h, d, 1, fp.chunk, fp.nsplit, 1, fp.group,
                                  int(fp.prep))
        else:
            assert args[7:18] == (b, l, s, h, d, fp.warps, fp.chunk, fp.nsplit, 1, 0, 0)
        assert args[18:] == (5, None, attention.keep_threshold(0.1), 1.0 / 0.9, 3, 7)
        assert sizes[-1] == fp.workspace_floats
        stats = torch.zeros(b, l, 2 * h)
        bp = bwd_plan_bf16(b, l, s, h, d)
        attention._launch_bwd(q, k, v, q, stats, q, h, None, 0.0, None)
        args = calls[-1]
        if isinstance(bp, WgBwdPlan):
            assert args[11:24] == (b, l, s, h, d, 1, bp.rows_per_split, bp.nsplit, 0, bp.group,
                                   bp.dq_group, bp.dq_chunk, bp.dq_nsplit)
        else:
            assert args[11:24] == (b, l, s, h, d, bp.key_warps, bp.rows_per_split, bp.nsplit,
                                   0, 0, 0, 1, 1)
        assert len(args) == 24 + 6  # then seed, seed slot, threshold, 1 / keep, b0, stream
        assert sizes[-1] == bp.workspace_floats
        assert (args[10] is None) == (bp.workspace_floats == 0)


def test_launch_plans_choose_the_plan_inside_the_block(monkeypatch):
    """attention.launch_plans: inside the block a call takes the plan its
    function returns (None: the default plan), nested blocks restore the
    outer choice, and after the block the default plans return."""
    calls = []
    monkeypatch.setattr(attention, "_fwd_bf16_fn", lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(attention, "_bwd_bf16_fn", lambda: lambda *a: calls.append(a) or 0)
    _fake_cuda(monkeypatch)
    b, l, s, h, d = 2, 333, 3126, 4, 15
    q, k, v = (torch.zeros(b, n, h * d, dtype=torch.bfloat16) for n in (l, s, s))
    stats = torch.zeros(b, l, 2 * h)
    seen = []

    def mma_fwd(*shape):
        seen.append(shape)
        return attention.fwd_plan(*shape[:5]) if shape[1] == l else None

    def fwd_body():
        attention._launch_fwd(q, k, v, h, None, 0.0, None)
        return "mma.sync" if calls[-1][16] == 0 else "wgmma"

    assert fwd_body() == "wgmma"
    with attention.launch_plans(fwd=mma_fwd):
        assert fwd_body() == "mma.sync"
        assert seen[-1] == (b, l, s, h, d, torch.bfloat16)
        with attention.launch_plans(fwd=lambda *shape: None,
                                    bwd=lambda *shape: attention.bwd_plan(*shape[:5])):
            assert fwd_body() == "wgmma"
            attention._launch_bwd(q, k, v, q, stats, q, h, None, 0.0, None)
            assert calls[-1][20] == 0  # the mma.sync body's group
        assert fwd_body() == "mma.sync"
        attention._launch_bwd(q, k, v, q, stats, q, h, None, 0.0, None)
        assert calls[-1][20] >= 1
    assert fwd_body() == "wgmma"


def test_bf16_launches_refuse_what_the_entries_do_not_take(monkeypatch):
    """Before any launch: float32 stats, one dtype for q, k, v and dO,
    contiguous tensors and head dims up to 64 (checked on fake CUDA
    launches here)."""
    monkeypatch.setattr(attention, "_fwd_bf16_fn", lambda: lambda *a: 0)
    monkeypatch.setattr(attention, "_bwd_bf16_fn", lambda: lambda *a: 0)
    _fake_cuda(monkeypatch)
    bf = torch.bfloat16
    q, k, v = (torch.zeros(2, n, 60, dtype=bf) for n in (70, 90, 90))
    stats = torch.zeros(2, 70, 8)
    with pytest.raises(ValueError, match="stats"):
        attention._launch_bwd(q, k, v, q, stats.to(bf), q, 4, None, 0.0, None)
    with pytest.raises(ValueError, match="grad_out"):
        attention._launch_bwd(q, k, v, q, stats, q.float(), 4, None, 0.0, None)
    with pytest.raises(ValueError, match="contiguous"):
        attention._launch_fwd(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, 4, None,
                              0.0, None)
    wide = [torch.zeros(2, n, 130, dtype=bf) for n in (70, 90, 90)]
    with pytest.raises(NotImplementedError, match="head dim"):
        attention._launch_fwd(*wide, 2, None, 0.0, None)


# ------------------------------------------------------------------ card
def _case(seed, b, l, s, e, heads, mask_kind):
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    q = rng.normal(size=(b, l, e)) * (e // heads) ** -0.5
    k, v = rng.normal(size=(b, s, e)), rng.normal(size=(b, s, e))
    g = rng.normal(size=(b, l, e))
    low = [torch.as_tensor(x, dtype=torch.float32, device=dev).to(torch.bfloat16)
           for x in (q, k, v, g)]
    mask = None
    if mask_kind is not None:
        m = rng.uniform(size=(b, s)) < 0.3
        m[:, 0] = False
        if mask_kind == "full_row":
            m[-1] = True
        mask = torch.as_tensor(m, device=dev)
    return low, mask


def _check(low, heads, mask, rate, seed, b0=0, fwd_plan=None, bwd_plan=None):
    """Both wgmma bodies against the bf16 plain versions and the float32
    plain version on the same bf16 inputs (bf16_errors' bound), stats at
    atol 2e-5 / rtol 1e-4, repeats bit-identical."""
    from act3d_tpu_torch.kernels import BWD_FLOOR, bf16_errors

    q, k, v, g = low
    runs = [attention._launch_fwd(q, k, v, heads, mask, rate, seed, fwd_plan, b0=b0)
            for _ in range(2)]
    out, stats = runs[0]
    grads = [attention._launch_bwd(q, k, v, out, stats, g, heads, mask, rate, seed, bwd_plan,
                                   b0=b0) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(out, runs[1][0]) and torch.equal(stats, runs[1][1])
    f32 = [x.float() for x in low]
    plain_out, plain_stats = fused_mha_forward_reference(q, k, v, heads, mask, rate, seed,
                                                         dropout_b0=b0)
    ref_out, _ = fused_mha_forward_reference(*f32[:3], heads, mask, rate, seed, dropout_b0=b0)
    errs = bf16_errors(out, plain_out, ref_out)
    assert errs["ok"], errs
    torch.testing.assert_close(stats, plain_stats, atol=2e-5, rtol=1e-4)
    plain = fused_mha_backward_reference(q, k, v, out, stats, g, heads, mask, rate, seed,
                                         dropout_b0=b0)
    ref = fused_mha_backward_reference(*f32[:3], out.float(), stats, f32[3], heads, mask,
                                       rate, seed, dropout_b0=b0)
    for got, again, p, r in zip(*grads, plain, ref):
        assert got.dtype == torch.bfloat16 and torch.equal(got, again)
        errs = bf16_errors(got, p, r, BWD_FLOOR)
        assert errs["ok"], errs


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mask_kind", [None, "full_row"])
@pytest.mark.parametrize("l", [17, 64, 65, 200])
@pytest.mark.parametrize("s", [1, 15, 63, 65, 130])
@pytest.mark.parametrize("e,heads", [(60, 4), (120, 8), (15, 1), (24, 8), (32, 2), (64, 2)])
def test_cuda_wgmma_bodies_ragged_edges(e, heads, s, l, mask_kind, rate):
    """On the card: L and S at the edges of the 64-row tile and the 64-key
    tile (S shorter than a tile, odd S, so that runs start off 16-byte
    lines; the backward on wgmma from L = 65), head widths E = 60 / 120, the
    core's H = 1, d = 15, the small models' d = 3, and d = 16 and 32 (DP 16,
    32); masks with a fully masked row; dropout with
    a batch offset b0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b = 3
    low, mask = _case(20, b, l, s, e, heads, mask_kind)
    assert isinstance(fwd_plan_bf16(b, l, s, heads, e // heads), WgFwdPlan)
    _check(low, heads, mask, rate, 11 if rate else None, b0=5 if rate else 0)


def _plans(b, l, s, e, heads, group, chunk, rows, prep):
    """Explicit wgmma plans of both bodies: ``group`` heads a block, key
    chunks of ``chunk`` keys (forward and dq), dk/dv row splits of ``rows``
    rows, the forward's key records on or off, and their workspaces."""
    chunk = min(chunk, s)
    q_tiles, k_tiles, nsplit = _cdiv(l, 64), _cdiv(s, 64), _cdiv(s, chunk)
    counters = q_tiles * (heads // group) * b
    op = 64 * attention._head_pad(e // heads) * 2  # bytes of one operand tile
    fwork = (b * k_tiles * heads * 2 * op // 4) * prep
    fwork += nsplit * b * l * (e + 2 * heads) + counters if nsplit > 1 else 0
    fplan = WgFwdPlan(group, q_tiles, chunk, nsplit, prep, nsplit * counters, fwork, 1 + prep)
    rsplit = _cdiv(l, rows)
    records = (b * q_tiles * heads * (4 * op + 1024) + b * k_tiles * heads * 3 * op) // 4
    bplan = WgBwdPlan(group, k_tiles, rows, rsplit, group, q_tiles, chunk, nsplit, 0, 0,
                      records, 2 * rsplit * b * s * e if rsplit > 1 else 0,
                      nsplit * b * l * e + counters if nsplit > 1 else 0, 4 + (rsplit > 1))
    return fplan, bplan


@pytest.mark.gpu
@pytest.mark.parametrize("prep", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("chunk,rows", [(64, 64), (128, 192), (320, 300), (1000, 64)])
def test_cuda_wgmma_any_plan(group, chunk, rows, rate, prep):
    """On the card: any head group, key chunk (split forward and dq, the
    last block of a tile combining the chunks) and row split (dk/dv slabs),
    the forward with and without its key records, gives the plain versions'
    results, bit-identical when repeated."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, l, s, e, heads = 2, 300, 257, 60, 4
    low, mask = _case(21, b, l, s, e, heads, "padded")
    fplan, bplan = _plans(b, l, s, e, heads, group, chunk, rows, prep)
    _check(low, heads, mask, rate, 3 if rate else None, fwd_plan=fplan, bwd_plan=bplan)


@pytest.mark.gpu
@pytest.mark.parametrize("prep", [False, True])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("chunk,rows", [(4096, 4096), (768, 192)])
@pytest.mark.parametrize("l,s,mask_kind,rate", [(333, 3126, None, 0.0),
                                                (65, 3074, "full_row", 0.1)])
def test_cuda_wgmma_d32_over_many_key_tiles(l, s, mask_kind, rate, chunk, rows, group, prep):
    """On the card: d = 32 (DP 32, the widest head the wgmma bodies take,
    two heads a block at most) at the training steps' S, where a chunk
    holds many key tiles (49 in one chunk, or 12 in each of five), with
    every head group, the forward with and without its key records, a mask with a
    fully masked row and dropout (DP = 64 failed exactly there, so d > 32
    keeps the mma.sync body)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, e, heads = 2, 64, 2
    low, mask = _case(23, b, l, s, e, heads, mask_kind)
    fplan, bplan = _plans(b, l, s, e, heads, group, chunk, rows, prep)
    _check(low, heads, mask, rate, 5 if rate else None, b0=3 if rate else 0,
           fwd_plan=fplan, bwd_plan=bplan)


@pytest.mark.gpu
@pytest.mark.parametrize("site", [(16, 333, 3126, 60, 4), (16, 50, 3074, 120, 8),
                                  (16, 3073, 53, 60, 4), (16, 3072, 53, 120, 8)])
def test_cuda_wgmma_bodies_at_the_training_sites(site):
    """On the card, at the bf16 training steps' main sites (one bf16 launch
    of each wrapper, no float32 one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, l, s, e, heads = site
    low, _ = _case(22, b, l, s, e, heads, None)
    rate = 0.1 if e == 120 else 0.0
    before = fused_mha_forward.launches, fused_mha_forward.launches_bf16
    fused_mha_forward(*low[:3], heads)
    assert (fused_mha_forward.launches, fused_mha_forward.launches_bf16) == (
        before[0], before[1] + 1)
    _check(low, heads, None, rate, 9 if rate else None)
