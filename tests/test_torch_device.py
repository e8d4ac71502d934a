"""The port's float32 precision policy (``act3d_tpu_torch.device``).

``pin_float32`` puts float32 matmuls and cuDNN convolutions in full
float32 (no TF32) through PyTorch's ``fp32_precision`` API alone, with
cuDNN's heuristic mode B (``TORCH_CUDNN_USE_HEURISTIC_MODE_B``), and
``resolve_device`` applies it to a CUDA device only.  The flags and the
environment are process-global and a pytest-xdist worker runs several
files in one process, so every test here restores them.  Runs on the CPU: the flags can
be set and read without a card.
"""

import os

import pytest
import torch

from act3d_tpu_torch import device as port_device
from act3d_tpu_torch.device import float32_precision, pin_float32, resolve_device

_FLAGS = (torch.backends.cuda.matmul, torch.backends.cudnn.conv)


@pytest.fixture(autouse=True)
def restore_flags(monkeypatch):
    monkeypatch.delenv(port_device.CUDNN_HEURISTIC_MODE_B, raising=False)
    saved = [f.fp32_precision for f in _FLAGS]
    yield
    for f, value in zip(_FLAGS, saved):
        f.fp32_precision = value


def test_pin_float32_sets_both_and_reads_back():
    torch.backends.cudnn.conv.fp32_precision = "tf32"  # PyTorch's default for convolutions
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    pin_float32()
    assert float32_precision() == {"matmul": "ieee", "conv": "ieee"}
    pin_float32()  # idempotent, and reading again does not raise
    assert float32_precision() == {"matmul": "ieee", "conv": "ieee"}
    assert os.environ[port_device.CUDNN_HEURISTIC_MODE_B] == "1"


def test_resolve_device_cpu_leaves_the_flags_alone():
    torch.backends.cudnn.conv.fp32_precision = "tf32"
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    before = float32_precision()
    assert resolve_device("cpu") == torch.device("cpu")
    assert float32_precision() == before == {"matmul": "tf32", "conv": "tf32"}
    assert port_device.CUDNN_HEURISTIC_MODE_B not in os.environ


def test_resolve_device_cuda_applies_the_policy(monkeypatch):
    """Where a card is present (faked here), resolving it pins float32."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls = []
    monkeypatch.setattr(port_device, "pin_float32", lambda: calls.append(1) or pin_float32())
    torch.backends.cudnn.conv.fp32_precision = "tf32"
    assert resolve_device("cuda").type == "cuda"
    assert calls == [1]
    assert float32_precision() == {"matmul": "ieee", "conv": "ieee"}
    assert os.environ[port_device.CUDNN_HEURISTIC_MODE_B] == "1"


def test_resolve_device_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("meta")
