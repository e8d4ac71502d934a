"""The yardstick's arithmetic: the card's peaks, the work and bound of an
attention call, and the attention sites of Act3D's and the planner's
forwards (which their adapters, benchmark/adapters, list for a keystep or
a training step).

``fwd_work``, ``bwd_work`` and ``tc_bound`` are frozen copies of
``chip_smoke.py``'s (the bound of PERF.md section 6: FLOPs at 165 TFLOP/s,
3xTF32 on the tensor cores; exponentials on 132 SMs x 16 special-function
lanes per clock at 1980 MHz; bytes at 3.35 TB/s, each input byte read and
each output byte written once).  The sites are derived from a
configuration's widths; for the shipped configurations they equal
``chip_smoke.py``'s tables ``SHAPES``, ``TRAIN_SHAPES`` and
``KEYPOSE_SHAPES`` (benchmark/tests/test_bench_work.py holds them to
those).  Peaks: NVIDIA's H100 SXM data sheet, dense, at 700 W.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_TC_F32_FLOPS = 495e12 / 3
EXP_PER_CLOCK = 132 * 16
SM_CLOCK_MHZ = 1980.0
PEAK_BYTES = 3.35e12


class Site(NamedTuple):
    """One attention core: L query rows over S keys of width E in H heads,
    batch B, a key mask or not, ``count`` calls per keystep or step."""

    name: str
    l: int
    s: int
    e: int
    h: int
    b: int
    masked: bool
    count: int


def fwd_work(l, s, e, h, b, masked):
    """FLOPs (q k^T and p v) and bytes (q, k, v, the mask read; out, stats
    written) of one forward call."""
    flops = 4.0 * b * l * s * e
    nbytes = 4.0 * (2 * b * l * e + 2 * b * s * e + 2 * b * l * h) + (b * s if masked else 0)
    return flops, nbytes


def bwd_work(l, s, e, h, b, masked):
    """Five (L, S, d) products per head; q, out, dO, k, v, stats (and the
    mask) read and dq, dk, dv written, each byte once."""
    flops = 10.0 * b * l * s * e
    nbytes = 4.0 * (4 * b * l * e + 4 * b * s * e + 2 * b * l * h) + (b * s if masked else 0)
    return flops, nbytes


def tc_bound(flops, exps, nbytes, sm_mhz=SM_CLOCK_MHZ):
    """Seconds: the largest of the FLOPs at 165 TFLOP/s, the exponentials
    at 132 x 16 per clock and the bytes at 3.35 TB/s."""
    return max(flops / PEAK_TC_F32_FLOPS, exps / (EXP_PER_CLOCK * sm_mhz * 1e6),
               nbytes / PEAK_BYTES)


def site_bound_s(site: Site, backward: bool) -> float:
    """The tensor-core bound of one call at ``site``, in seconds."""
    work = bwd_work if backward else fwd_work
    flops, nbytes = work(site.l, site.s, site.e, site.h, site.b, site.masked)
    return tc_bound(flops, site.b * site.l * site.s * site.h, nbytes)


def act3d_sites(a: Dict, batch: int, training: bool) -> List[Site]:
    """Act3D's attention cores per forward: at every level the vis-ins
    stack (the fine context and the gripper over the instruction), the
    ghost-point stack (ghost points over context, gripper and
    instruction) and the query stack (one row)."""
    ncam, levels = a["ncam"], a["num_sampling_level"]
    ctx = 32 * 32 * ncam
    n_ghost = (a["num_ghost_points"] if training else a["num_ghost_points_val"]) // levels
    e, h = a["embedding_dim"], a["num_attn_heads"]
    full = ctx + 1 + a["instruction_tokens"]
    return [
        Site("act3d.vis_ins", ctx + 1, a["instruction_tokens"], e, h, batch, False,
             levels * a["num_vis_ins_attn_layers"]),
        Site("act3d.ghost_point", n_ghost, full, e, h, batch, False,
             levels * a["num_ghost_point_cross_attn_layers"]),
        Site("act3d.query", 1, full, e, h, batch, False,
             levels * a["num_query_cross_attn_layers"]),
    ]


def planner_sites(p: Dict, batch: int, per_denoise: int = 1) -> List[Site]:
    """The denoiser's attention cores per evaluation, times ``per_denoise``:
    the vision-language stack (visual tokens over the instruction), the
    trajectory-language layer, and cross (trajectory over visual tokens,
    gripper and goal) and self attention in each layer of the trajectory,
    position and rotation stacks."""
    tokens = 32 * 32 * p["ncam"]
    e, h, length = p["embedding_dim"], p["num_attn_heads"], p["trajectory_length"]
    layers = (p["num_query_cross_attn_layers"] - 2) + 2 + 2
    return [
        Site("planner.vl", tokens, p["instruction_tokens"], e, h, batch, False,
             p["num_vis_ins_attn_layers"] * per_denoise),
        Site("planner.traj_lang", length, p["instruction_tokens"], e, h, batch, False,
             per_denoise),
        Site("planner.cross", length, tokens + 2, e, h, batch, False, layers * per_denoise),
        Site("planner.self", length, length, e, h, batch, True, layers * per_denoise),
    ]


def bound_s(sites: List[Site], backward: bool = False) -> float:
    """Σ over the sites of count x the bound of one call, in seconds."""
    return sum(site.count * site_bound_s(site, backward) for site in sites)
