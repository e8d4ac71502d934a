"""Same-call A/B of the fused-MHA kernels' launch plans on the card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 scripts/ab_fused_mha_plans.py [--out profiles/ab_fused_mha_plans.json]
        [--dtype float32|bf16|both]

Every knob of ``act3d_tpu_torch/kernels/attention.py``'s plans
(``FWD_TARGET_BLOCKS``, ``FWD_MAX_WARPS``, ``FWD_MIN_CHUNK``,
``BWD_TARGET_BLOCKS``, ``BWD_KEY_WARPS``) and the compile-time tile of each
source (the forward's key tile ``ACT3D_FWD_KEY_TILE``, the backward's row
tile ``ACT3D_BWD_ROW_TILE``, built here with ``-D`` beside the default
library) is varied one at a time around the defaults.  Each variant's
device time (calls captured in a CUDA graph, as ``chip_smoke.py`` times
them) is taken at every main-path attention site of ``chip_smoke.py``
(serving keystep, ChainedDiffuser and Act3D training steps) and summed over
each unit's launches.  The default is timed first and again last, so its
two readings give the spread.  Prints one line per variant and unit, and
writes every per-site time to ``--out``.

The bf16 entries (``--dtype bf16``) are varied the same way at the bf16
training steps' sites: every knob of ``fwd_plan_bf16`` / ``bwd_plan_bf16``
(blocks wanted, heads per block or head groups, the dq pass's target and
fewest heads, the smallest key chunk, the forward's key records off, where
several query tiles read a key tile (the default) or at every site ("all"), the
mma.sync body's plan at the shapes it keeps), the wgmma bodies' compile-time
ring depth (``ACT3D_WG_STAGES``), builds of a patched copy of the sources
that leave one part of every tile out to split its time ("split": 1 the
re-layout, 2 the per-score arithmetic, 3 the products; wrong results, timed
only), and, as the yardstick, the mma.sync body with the float32 entry's
plans.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from act3d_tpu_torch.kernels import _build  # noqa: E402
from act3d_tpu_torch.kernels import attention as A  # noqa: E402

FWD_KNOBS = {"target_blocks": (132, 264, 528, 1056), "max_warps": (1, 2, 4, 8),
             "min_chunk": (32, 64, 128, 256)}
BWD_KNOBS = {"target_blocks": (132, 264, 528, 1056), "key_warps": (2, 4, 8)}
TILES = {"fused_mha_fwd.cu": ("ACT3D_FWD_KEY_TILE", (16, 64)),
         "fused_mha_bwd.cu": ("ACT3D_BWD_ROW_TILE", (16, 64))}


def sites(dev, dtype=torch.float32):
    """(unit, site, launches per unit, bwd?, tensors) of every main-path
    attention site of chip_smoke.py, with seeded inputs; at bf16 the
    training steps' sites only (serving runs in float32)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []

    def make(unit, site, n, b, l, s, e, h, mask, rate, bwd):
        d = e // h
        q = (torch.randn(b, l, e, generator=gen, device=dev) * d ** -0.5).to(dtype)
        k, v, g = (torch.randn(b, m, e, generator=gen, device=dev).to(dtype)
                   for m in (s, s, l))
        seed = 17 if rate else None
        o, st = A.fused_mha_forward(q, k, v, h, mask, True, rate, seed)
        out.append(dict(unit=unit, site=site, n=n, bwd=bwd, shape=(b, l, s, h, d),
                        args=(q, k, v, h, mask, rate, seed), bwd_args=(q, k, v, o, st, g, h,
                                                                        mask, rate, seed)))

    for site, l, s, e, h, kind, n in (cs.SHAPES if dtype == torch.float32 else ()):
        if n:
            make("serve_keystep", site, n, 1, l, s, e, h, cs.make_mask(kind, s, dev), 0.0,
                 False)
    for unit, shapes, e, h in (("diffuser_step", cs.TRAIN_SHAPES, 120, 8),
                               ("act3d_step", cs.KEYPOSE_SHAPES, 60, 4)):
        for site, l, s, kind, rate, n in shapes:
            if n:
                make(unit, site, n, cs.TRAIN_B, l, s, e, h,
                     cs.train_mask(kind, cs.TRAIN_B, s, dev), rate, True)
    return out


# Split builds of the bf16 wgmma bodies: a copy of a source that leaves one
# part of every tile out, to split a tile's time (wrong results, timed
# only): 1 the re-layout, 2 the per-score arithmetic, 3 the products.
LEFT_OUT = """
template <typename... T> __device__ __forceinline__ void act3d_left_out(T&&...) {}
template <int A, int B, typename... T>
__device__ __forceinline__ void act3d_left_out2(T&&...) {}
template <int A, int B, bool C, typename... T>
__device__ __forceinline__ void act3d_left_out3(T&&...) {}
"""
# each wgmma kernel's per-score arithmetic: (its first line, the line after it)
SCORE_BLOCKS = {
    "fused_mha_fwd.cu": [
        ("    // element 4i + e of s: row g (e < 2) or g + 8, key 8i + 2t + (e & 1)\n",
         "    uint32_t pa[NK / 16][4];")],
    "fused_mha_bwd.cu": [
        ("    // element 4i + e: key g (e < 2) or g + 8, query row 8i + 2t + (e & 1)\n",
         "    uint32_t pa[RT / 16][4], da[RT / 16][4];"),
        ("    // element 4i + e: row g (e < 2) or g + 8, key 8i + 2t + (e & 1)\n",
         "    uint32_t da[NK / 16][4];")],
}


def split_source(source: str, part: int) -> str:
    """The text of ``source`` with ``part`` of every wgmma tile left out."""
    text = (_build.CSRC_DIR / source).read_text()
    include = '#include "mha_wgmma_bf16.cuh"\n'
    assert text.count(include) == 1
    text = text.replace(include, include + LEFT_OUT)
    if part == 1:
        calls = {"act3d_wg_direct<": "act3d_left_out2<", "act3d_wg_trans<": "act3d_left_out3<"}
    elif part == 3:
        calls = {"act3d_wgmma_rs_n64(": "act3d_left_out(", "act3d_mma_rs<": "act3d_left_out2<"}
    else:
        calls = {}
        for first, after in SCORE_BLOCKS[source]:
            assert text.count(first) == 1 and text.count(after) == 1, first
            i, j = text.index(first) + len(first), text.index(after)
            text = text[:i] + "    if (false) {\n" + text[i:j] + "    }\n" + text[j:]
    for call, left_out in calls.items():
        assert call in text, call
        text = text.replace(call, left_out)
    return text


def build_variants(out_dir: Path, tiles):
    """One library per (source, macro, value) of ``tiles``, all nvcc runs
    started together; macro "split" builds split_source(source, value)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    cmds = {}  # every patched source written before any nvcc starts
    for source, macro, value in tiles:
        lib = out_dir / f"{Path(source).stem}-{macro}-{value}.so"
        if macro == "split":
            src = out_dir / f"{Path(source).stem}-split-{value}.cu"
            src.write_text(split_source(source, value))
            flags = [f"-I{_build.CSRC_DIR}", str(src)]
        else:
            flags = [f"-D{macro}={value}", str(_build.CSRC_DIR / source)]
        cmds[(source, macro, value)] = (lib, [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                                              str(lib), *flags])
    procs = {key: (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True)) for key, (lib, cmd) in cmds.items()}
    logs = {key: proc.communicate()[0] for key, (_, proc) in procs.items()}
    for key, (_, proc) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{logs[key]}")
    return {key: ctypes.CDLL(str(lib)) for key, (lib, _) in procs.items()}


BF16_FWD_KNOBS = {"target_blocks": (132, 264, 528), "head_groups": (1, 2, 4),
                  "solo_group": (1, 2, 4),
                  "min_chunk": (256, 512, 1024, 2048), "prep": (False, True, "all"),
                  "mma_target_blocks": (132, 264, 528, 1056)}
BF16_BWD_KNOBS = {"target_blocks": (132, 264, 528), "min_rows": (64, 256, 384, 768),
                  "max_group": (1, 2, 4),
                  "dq_target_blocks": (132, 264, 528), "dq_min_group": (1, 2, 4),
                  "mma_key_warps": (1, 2, 4, 8)}
BF16_TILES = {"ACT3D_WG_STAGES": (2, 3), "split": (1, 2, 3)}


def all_records(plan, b, l, s, h, d):
    """``plan`` with the key records at every wgmma forward site: the
    default plan writes them only where several query tiles read a key
    tile (the backward reads records at every site)."""
    dp = A._head_pad(d)
    if isinstance(plan, A.WgFwdPlan) and not plan.prep:
        rec = b * A._cdiv(s, A.WG_KEYS) * h * A.record_bytes("fwd_keys", dp) // 4
        return plan._replace(prep=True, workspace_floats=plan.workspace_floats + rec,
                             kernels=plan.kernels + 1)
    return plan


def variant_fn(lib, source, bf16=False):
    """The library function of one variant, typed as the wrapper types it."""
    fwd = source == "fused_mha_fwd.cu"
    name = f"act3d_fused_mha_{'fwd' if fwd else 'bwd'}_{'bf16' if bf16 else 'f32'}"
    ints = 9 + (0 if not bf16 else 2 if fwd else 4)  # the bf16 entries' body and plan ints
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * (7 if fwd else 11) + [ctypes.c_int] * ints
                   + [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float,
                      ctypes.c_uint32, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def time_sites(all_sites, side, direction, plan_of):
    """{site: ms} of one variant: the forward (direction 'fwd') or the
    backward ('bwd') at every site that runs it."""
    times = {}
    for st in all_sites:
        if direction == "bwd" and not st["bwd"]:
            continue
        plan = plan_of(*st["shape"])
        b, l, s = st["shape"][:3]
        iters = 20 if b * l * s > 1e6 else 100
        if direction == "fwd":
            def run(st=st, plan=plan):
                return A._launch_fwd(*st["args"], plan=plan)
        else:
            def run(st=st, plan=plan):
                return A._launch_bwd(*st["bwd_args"], plan=plan)
        try:
            times[st["site"]] = cs.device_ms(run, iters, side)
        except RuntimeError as err:  # a plan the entry refuses (shared memory)
            print(f"  {direction} {st['site']}: {err}", flush=True)
            times[st["site"]] = float("nan")
    return times


def per_unit(all_sites, times):
    units = {}
    for st in all_sites:
        if st["site"] in times:
            units[st["unit"]] = units.get(st["unit"], 0.0) + st["n"] * times[st["site"]]
    return units


def run_float32(side, card, dev, record):
    """The float32 entries: every plan knob, then each source's tile."""
    all_sites = sites(dev)
    libs = build_variants(_build.BUILD_DIR / "ab", [
        (src, macro, v) for src, (macro, values) in TILES.items() for v in values])
    defaults = {"fwd": dict(target_blocks=A.FWD_TARGET_BLOCKS, max_warps=A.FWD_MAX_WARPS,
                            min_chunk=A.FWD_MIN_CHUNK),
                "bwd": dict(target_blocks=A.BWD_TARGET_BLOCKS, key_warps=A.BWD_KEY_WARPS)}
    planners = {"fwd": A.fwd_plan, "bwd": A.bwd_plan}
    for direction, knobs in (("fwd", FWD_KNOBS), ("bwd", BWD_KNOBS)):
        planner = planners[direction]
        record(all_sites, direction, "default", "first", time_sites(
            all_sites, side, direction, planner))
        for knob, values in knobs.items():
            for value in values:
                kw = dict(defaults[direction], **{knob: value})
                record(all_sites, direction, knob, value, time_sites(
                    all_sites, side, direction, lambda *shape, kw=kw: planner(*shape, **kw)))
        source = f"fused_mha_{direction}.cu"
        macro, values = TILES[source]
        getter = "_fwd_fn" if direction == "fwd" else "_bwd_fn"
        default_fn = getattr(A, getter)
        for value in values:
            fn = variant_fn(libs[(source, macro, value)], source)
            setattr(A, getter, lambda fn=fn: fn)
            try:
                record(all_sites, direction, macro, value, time_sites(all_sites, side,
                                                                      direction, planner))
            finally:
                setattr(A, getter, default_fn)
        record(all_sites, direction, "default", "last", time_sites(all_sites, side, direction,
                                                                   planner))


def run_bf16(side, card, dev, record, only=None):
    """The bf16 entries: the mma.sync body as yardstick, every knob of the
    wgmma plans, then each compile-time variant of the wgmma bodies at the
    default plans; ``only``: the knob and macro names to vary (all by
    default)."""
    all_sites = sites(dev, torch.bfloat16)
    tiles = {m: v for m, v in BF16_TILES.items() if only is None or m in only}
    # the backward re-lays nothing in its main kernels (it reads records)
    variants = [(src, macro, v) for src in ("fused_mha_fwd.cu", "fused_mha_bwd.cu")
                for macro, values in tiles.items() for v in values
                if (src, macro, v) != ("fused_mha_bwd.cu", "split", 1)]
    libs = build_variants(_build.BUILD_DIR / "ab_bf16", variants)
    defaults = {"fwd": dict(target_blocks=A.WG_FWD_TARGET_BLOCKS,
                            head_groups=A.WG_FWD_HEAD_GROUPS,
                            solo_group=A.WG_FWD_SOLO_GROUP, min_chunk=A.WG_FWD_MIN_CHUNK,
                            prep=True, mma_target_blocks=A.MMA_FWD_TARGET_BLOCKS),
                "bwd": dict(target_blocks=A.WG_BWD_TARGET_BLOCKS, min_rows=A.WG_BWD_MIN_ROWS,
                            max_group=A.WG_BWD_MAX_GROUP,
                            dq_target_blocks=A.WG_DQ_TARGET_BLOCKS,
                            dq_min_group=A.WG_DQ_MIN_GROUP,
                            mma_key_warps=A.MMA_BWD_KEY_WARPS)}
    planners = {"fwd": A.fwd_plan_bf16, "bwd": A.bwd_plan_bf16}
    mma = {"fwd": A.fwd_plan, "bwd": A.bwd_plan}
    for direction, knobs in (("fwd", BF16_FWD_KNOBS), ("bwd", BF16_BWD_KNOBS)):
        planner = planners[direction]
        record(all_sites, direction, "bf16 default", "first", time_sites(
            all_sites, side, direction, planner))
        record(all_sites, direction, "bf16 body", "mma.sync", time_sites(
            all_sites, side, direction, mma[direction]))
        for knob, values in knobs.items():
            if only is not None and knob not in only:
                continue
            for value in values:
                if value == "all":
                    def plan_of(*shape, kw=defaults[direction]):
                        return all_records(planner(*shape, **kw), *shape)
                else:
                    def plan_of(*shape, kw=dict(defaults[direction], **{knob: value})):
                        return planner(*shape, **kw)
                record(all_sites, direction, f"bf16 {knob}", value, time_sites(
                    all_sites, side, direction, plan_of))
        source = f"fused_mha_{direction}.cu"
        getter = "_fwd_bf16_fn" if direction == "fwd" else "_bwd_bf16_fn"
        default_fn = getattr(A, getter)
        for source_, macro, value in variants:
            if source_ == source:
                fn = variant_fn(libs[(source, macro, value)], source, bf16=True)
                setattr(A, getter, lambda fn=fn: fn)
                try:
                    record(all_sites, direction, f"bf16 {macro}", value, time_sites(
                        all_sites, side, direction, planner))
                finally:
                    setattr(A, getter, default_fn)
        record(all_sites, direction, "bf16 default", "last", time_sites(
            all_sites, side, direction, planner))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="profiles/ab_fused_mha_plans.json")
    parser.add_argument("--dtype", choices=("float32", "bf16", "both"), default="both")
    parser.add_argument("--only", nargs="+", default=None,
                        help="bf16: vary only these knobs and macros (e.g. prep)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ab_fused_mha_plans: no CUDA device", file=sys.stderr)
        return 1
    card = cs.nvidia_smi()
    print(card, flush=True)
    dev = torch.device("cuda")
    side = torch.cuda.Stream()
    _build.build(("fused_mha_fwd.cu", "fused_mha_bwd.cu"))
    results = []

    def record(all_sites, direction, knob, value, times):
        units = per_unit(all_sites, times)
        results.append(dict(direction=direction, knob=knob, value=value, sites=times,
                            units=units))
        print(f"{direction} {knob}={value}: " + ", ".join(
            f"{u} {ms:.4f} ms" for u, ms in units.items()) + " | " + ", ".join(
            f"{site} {ms * 1e3:.1f}" for site, ms in times.items()) + f" us | {card}",
            flush=True)

    if args.dtype in ("float32", "both"):
        run_float32(side, card, dev, record)
    if args.dtype in ("bf16", "both"):
        run_bf16(side, card, dev, record, args.only)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(card=card, results=results), indent=1))
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
