"""Same-call A/B of the fused-MHA kernels' launch plans on the card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 scripts/ab_fused_mha_plans.py [--out profiles/ab_fused_mha_plans.json]

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


def sites(dev):
    """(unit, site, launches per unit, bwd?, tensors) of every main-path
    attention site of chip_smoke.py, with seeded inputs."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []

    def make(unit, site, n, b, l, s, e, h, mask, rate, bwd):
        d = e // h
        q = torch.randn(b, l, e, generator=gen, device=dev) * d ** -0.5
        k, v, g = (torch.randn(b, m, e, generator=gen, device=dev) for m in (s, s, l))
        seed = 17 if rate else None
        o, st = A.fused_mha_forward(q, k, v, h, mask, True, rate, seed)
        out.append(dict(unit=unit, site=site, n=n, bwd=bwd, shape=(b, l, s, h, d),
                        args=(q, k, v, h, mask, rate, seed), bwd_args=(q, k, v, o, st, g, h,
                                                                        mask, rate, seed)))

    for site, l, s, e, h, kind, n in cs.SHAPES:
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


def build_variants(out_dir: Path):
    """One library per (source, tile value), all nvcc runs started together."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source, (macro, values) in TILES.items():
        for value in values:
            lib = out_dir / f"{Path(source).stem}-{macro}-{value}.so"
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-D{macro}={value}", "-o",
                   str(lib), str(_build.CSRC_DIR / source)]
            procs[(source, value)] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def variant_fn(lib, source):
    """The library function of one variant, typed as the wrapper types it."""
    if source == "fused_mha_fwd.cu":
        fn = lib.act3d_fused_mha_fwd_f32
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                       + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p])
    else:
        fn = lib.act3d_fused_mha_bwd_f32
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                       + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p])
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
        times[st["site"]] = cs.device_ms(run, iters, side)
    return times


def per_unit(all_sites, times):
    units = {}
    for st in all_sites:
        if st["site"] in times:
            units[st["unit"]] = units.get(st["unit"], 0.0) + st["n"] * times[st["site"]]
    return units


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="profiles/ab_fused_mha_plans.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ab_fused_mha_plans: no CUDA device", file=sys.stderr)
        return 1
    card = cs.nvidia_smi()
    print(card, flush=True)
    dev = torch.device("cuda")
    side = torch.cuda.Stream()
    _build.build(("fused_mha_fwd.cu", "fused_mha_bwd.cu"))
    libs = build_variants(_build.BUILD_DIR / "ab")
    all_sites = sites(dev)
    results = []

    def record(direction, knob, value, times):
        units = per_unit(all_sites, times)
        results.append(dict(direction=direction, knob=knob, value=value, sites=times,
                            units=units))
        print(f"{direction} {knob}={value}: " + ", ".join(
            f"{u} {ms:.4f} ms" for u, ms in units.items()) + f" | {card}", flush=True)

    defaults = {"fwd": dict(target_blocks=A.FWD_TARGET_BLOCKS, max_warps=A.FWD_MAX_WARPS,
                            min_chunk=A.FWD_MIN_CHUNK),
                "bwd": dict(target_blocks=A.BWD_TARGET_BLOCKS, key_warps=A.BWD_KEY_WARPS)}
    planners = {"fwd": A.fwd_plan, "bwd": A.bwd_plan}
    for direction, knobs in (("fwd", FWD_KNOBS), ("bwd", BWD_KNOBS)):
        planner = planners[direction]
        record(direction, "default", "first", time_sites(
            all_sites, side, direction, planner))
        for knob, values in knobs.items():
            for value in values:
                kw = dict(defaults[direction], **{knob: value})
                record(direction, knob, value, time_sites(
                    all_sites, side, direction, lambda *shape, kw=kw: planner(*shape, **kw)))
        source = f"fused_mha_{direction}.cu"
        macro, values = TILES[source]
        getter = "_fwd_fn" if direction == "fwd" else "_bwd_fn"
        default_fn = getattr(A, getter)
        for value in values:
            fn = variant_fn(libs[(source, value)], source)
            setattr(A, getter, lambda fn=fn: fn)
            try:
                record(direction, macro, value, time_sites(all_sites, side, direction,
                                                           planner))
            finally:
                setattr(A, getter, default_fn)
        record(direction, "default", "last", time_sites(all_sites, side, direction, planner))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(card=card, results=results), indent=1))
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
