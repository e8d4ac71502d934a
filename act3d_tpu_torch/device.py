"""Device selection and float32 precision policy for the port's entry
points, and the stream rule: CUDA graphs cannot be captured on the legacy
default stream, and each stream gets cuBLAS workspaces of its own, which
outlive it, so captured or replayed work (``Trainer.step``,
``Actioner.predict``) runs on :func:`graph_stream` through :func:`on_stream`."""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import torch


# PyTorch reads this once, at the first cuDNN convolution of the process
CUDNN_HEURISTIC_MODE_B = "TORCH_CUDNN_USE_HEURISTIC_MODE_B"


def pin_float32() -> None:
    """The port's precision policy on the card: float32 matmuls and cuDNN
    convolutions in full float32, never TF32 (about 10 mantissa bits), as
    the JAX package computes on the CPU.  PyTorch's default runs cuDNN
    convolutions in TF32, which would put the frozen CLIP trunk and the
    FPN at TF32 while every card-vs-CPU check holds float32.

    Set through PyTorch's ``fp32_precision`` API only: mixing it with the
    legacy ``allow_tf32`` flags makes a later read of those raise, so the
    port reads the policy back with :func:`float32_precision`.

    Without TF32, cuDNN's instant heuristics (PyTorch's default) put first
    float32 engines whose workspaces take GiBs: 10 GiB for the FPN's 3x3
    output convolution over 48 x 120 x 128^2 on an H100, the float32
    training step's peak (scripts/conv_memory.py).  cuDNN's heuristic mode
    B ranks the float32 engines otherwise (at most 2.4 GiB of workspace
    there, still no TF32), so it is part of the policy; it must be set
    before the process runs its first cuDNN convolution, as every entry
    point does through :func:`resolve_device`."""
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    os.environ[CUDNN_HEURISTIC_MODE_B] = "1"


def float32_precision() -> dict:
    """The float32 precision of matmuls and cuDNN convolutions, read through
    the API :func:`pin_float32` sets ("ieee" = full float32)."""
    return {"matmul": torch.backends.cuda.matmul.fp32_precision,
            "conv": torch.backends.cudnn.conv.fp32_precision}


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.

    The default is the card.  Without one, asking for ``"cuda"`` raises
    instead of drifting to the CPU; the CPU is used only when the caller
    names it.  Under a launcher (``torchrun`` sets ``LOCAL_RANK``) a bare
    ``"cuda"`` is this rank's card, ``cuda:LOCAL_RANK`` (modulo the cards
    present, so several ranks may share one), made the current device.
    A CUDA device gets the float32 policy of :func:`pin_float32`; the CPU
    computes in float32 already, and its flags are left alone.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if dev.index is None and "LOCAL_RANK" in os.environ:
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        pin_float32()
    return dev


_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def graph_stream(device: torch.device) -> Optional["torch.cuda.Stream"]:
    """The stream of ``device`` that captured work runs on, one per device
    and process; None on the CPU."""
    if device.type != "cuda":
        return None
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(index)
    return _STREAMS[index]


@contextlib.contextmanager
def on_stream(stream: Optional["torch.cuda.Stream"]):
    """Run the block on ``stream``, ordered after the caller's current
    stream at entry and before it at exit, so the caller's work before and
    after sees the block's results; with None, where the caller is."""
    if stream is None:
        yield
        return
    caller = torch.cuda.current_stream(stream.device)
    stream.wait_stream(caller)
    try:
        with torch.cuda.stream(stream):
            yield
    finally:
        caller.wait_stream(stream)
