"""How well the small bf16 steps of chip_smoke.py's phase 9b determine their
gradients on the card, and what the phase's comparison reads for sound
attention bodies.

Run from the repository root on a machine with one NVIDIA H100:

    python3 scripts/probe_bf16_step_conditioning.py [--batch 8|2]

The small ChainedDiffuser step (the phase's model and injected draws,
dropout off, the planner's batch 8 as in the phase or 2) is taken on the
CPU once and on the card four times: with the kernels, with the bf16
forward's mma.sync body at the L = 512 vl sites (through
``launch_plans``), with every fused-MHA call computed by its plain
versions in torch ops on the card (the model's ``FusedMHA`` swapped for
the plain functions under autograd), and with the same plain versions but
one element of the first vl call's output moved up one bf16 ulp.  Each
card step runs twice: with its own loss cotangents, and carrying the CPU
step's cotangents back from the regressor outputs (the phase's check).
Prints, per run, both gradients' cosine similarity and relative L2
distance to the CPU step's and to the plain versions' on the card, the
loss cotangent signs that differ from the CPU step's, then the small Act3D
step's distance to the CPU with the kernels and with the plain versions,
and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from act3d_tpu_torch.device import resolve_device  # noqa: E402
from act3d_tpu_torch.kernels import attention as A  # noqa: E402
from act3d_tpu_torch.ops import attention as attention_ops  # noqa: E402

VL_ROWS = 512  # 2 cameras x (64 / 4)^2 visual tokens


class PlainMHA(torch.autograd.Function):
    """FusedMHA's contract computed by the plain versions, on any device;
    ``ulp`` (a one-element list) moves one element of the first L = 512
    output up one bf16 ulp."""

    ulp: list = []

    @staticmethod
    def forward(ctx, q, k, v, num_heads, mask, rate, seed, b0=0):
        out, stats = A.fused_mha_forward_reference(q, k, v, num_heads, mask, rate, seed,
                                                   dropout_b0=b0)
        if PlainMHA.ulp and q.shape[1] == VL_ROWS and out.dtype == torch.bfloat16:
            PlainMHA.ulp.clear()
            bits = out.view(torch.int16).clone()
            bits.view(-1)[12345] += 1
            out = bits.view(torch.bfloat16)
        ctx.save_for_backward(q, k, v, out, stats, mask)
        ctx.args = (num_heads, rate, seed, b0)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, stats, mask = ctx.saved_tensors
        h, rate, seed, b0 = ctx.args
        dq, dk, dv = A.fused_mha_backward_reference(q, k, v, out, stats, grad.contiguous(), h,
                                                    mask, rate, seed, dropout_b0=b0)
        return dq, dk, dv, None, None, None, None, None


@contextlib.contextmanager
def plain_versions(ulp=False):
    fused = attention_ops.FusedMHA
    attention_ops.FusedMHA = PlainMHA
    PlainMHA.ulp[:] = [True] if ulp else []
    try:
        yield
    finally:
        attention_ops.FusedMHA = fused


def mma_sync_at_vl(b, l, s, h, d, dtype):
    return A.fwd_plan(b, l, s, h, d) if l == VL_ROWS and dtype == torch.bfloat16 else None


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, choices=(2, 8), default=8,
                        help="the small planner's batch")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_bf16_step_conditioning: no CUDA device", file=sys.stderr)
        return 1
    dev = resolve_device("cuda")
    models = {}
    for name, make, cfg, run, is_output in cs.small_bf16_setup(args.batch):
        torch.manual_seed(cs.SEED)
        cpu_model = make(**cfg, device="cpu")
        card = make(**cfg, device=dev)
        card.load_state_dict(cpu_model.state_dict())
        models[name] = (cpu_model, card, run, is_output)

    cpu_model, card, run, is_output = models["diffusion"]
    _, cpu, cpu_cot = cs.small_bf16_step(cpu_model, "cpu", run, is_output)
    runs = {"kernels": contextlib.nullcontext,
            "mma.sync forward at the vl sites": lambda: A.launch_plans(fwd=mma_sync_at_vl),
            "plain versions": plain_versions,
            "plain versions, one ulp moved": lambda: plain_versions(ulp=True)}
    got = {}
    for name, ctx in runs.items():
        with ctx():
            _, own, cot = cs.small_bf16_step(card, dev, run, is_output)
        with ctx():
            _, held, _ = cs.small_bf16_step(card, dev, run, is_output, cpu_cot)
        flips = sum(int((torch.sign(a) != torch.sign(b)).sum()) for a, b in zip(cot, cpu_cot))
        got[name] = (own, held, flips)
    plain_own, plain_held, _ = got["plain versions"]
    for name, (own, held, flips) in got.items():
        total = sum(a.numel() for a in cpu_cot)
        line = [f"diffusion at batch {args.batch}, {name}: {flips} of {total} loss cotangent "
                "signs differ from the CPU step's"]
        for label, grads, plain in (("own cotangents", own, plain_own),
                                    ("the CPU step's cotangents", held, plain_held)):
            c_cos, c_rel = cs._cos_rel(grads, cpu)
            p_cos, p_rel = cs._cos_rel(grads, plain)
            line.append(f"{label}: vs the CPU step cosine {c_cos:.5f} relative L2 "
                        f"{c_rel:.4e}, vs the plain versions cosine {p_cos:.5f} relative L2 "
                        f"{p_rel:.4e}")
        print("; ".join(line), flush=True)

    cpu_model, card, run, _ = models["keypose"]
    _, cpu, _ = cs.small_bf16_step(cpu_model, "cpu", run)
    for name, ctx in (("kernels", contextlib.nullcontext), ("plain versions", plain_versions)):
        with ctx():
            _, own, _ = cs.small_bf16_step(card, dev, run)
        c_cos, c_rel = cs._cos_rel(own, cpu)
        print(f"keypose (planner batch {args.batch}), {name}: vs the CPU step cosine "
              f"{c_cos:.5f} relative L2 {c_rel:.4e}", flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
