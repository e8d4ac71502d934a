"""Hand-written CUDA kernels of the port (the fused attention forward and
backward, the single-head-layout attention core, the row-gather adjoint's
three entries), each with its plain PyTorch version beside it.  The CUDA
sources live in ``../csrc`` and are built by ``_build`` at first use, never
at import.  Every kernel has a float32 and a bf16 entry."""

from __future__ import annotations

import math

import torch


BWD_FLOOR = 1e-5  # float32 noise of a cancelled gradient, for bf16_errors


def count_launch(wrapper, dtype: torch.dtype) -> None:
    """One launch of ``wrapper``'s kernel entry for ``dtype``: bf16 entries
    count in ``wrapper.launches_bf16``, float32 ones in ``wrapper.launches``."""
    if dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


def bf16_ulp(scale: float) -> float:
    """One bf16 ulp at magnitude ``scale`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(scale)) - 7) if scale > 0 else 0.0


def bf16_errors(got: torch.Tensor, plain: torch.Tensor, ref: torch.Tensor,
                floor: float = 0.0) -> dict:
    """How far a bf16 kernel's result ``got`` lies from its bf16 plain
    version's ``plain`` (``max_abs_err``), how far both lie from the float32
    plain version's ``ref`` on the same bf16-rounded inputs, and the bound
    the kernel's error against ref is held to: twice the plain version's
    plus one bf16 ulp of ref's largest magnitude (the two round at the same
    points but sum in another order, so one rounding may land one ulp
    apart), that ulp at least ``floor``.  The backward passes a floor of
    float32 noise: where a gradient cancels to zero (one key, no dropout:
    dp - delta = 0), every version holds only the float32 rounding of its
    own sums.  ``ok`` says whether the kernel is within the bound."""
    ref = ref.float()
    kernel_err = (got.float() - ref).abs().max().item()
    plain_err = (plain.float() - ref).abs().max().item()
    bound = 2.0 * plain_err + max(bf16_ulp(ref.abs().max().item()), floor)
    return dict(max_abs_err=(got.float() - plain.float()).abs().max().item(),
                kernel_vs_f32=kernel_err, plain_vs_f32=plain_err, bound=bound,
                ok=kernel_err <= bound)
