"""Training engine: steps, evaluation, checkpoints, logging.

Counterpart of ``act3d_tpu/train/engine.py`` on one device: the loss and
its backward run eagerly (the attention cores through the fused kernels),
AdamW (``train/optim.py``) steps the trainable params, and checkpoints
keep JAX's best/last semantics in ``best.pt`` / ``last.pt`` (JAX writes
``.msgpack``); :func:`resume` is the CLIs' ``--checkpoint`` /
``--auto_resume``.  The dp/fsdp mesh of the JAX trainer is not ported yet.
"""

from __future__ import annotations

import json
import signal
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import torch
import torch.nn as nn

from ..nn.dropout import Generators
from .optim import GradientAccumulator, make_optimizer

__all__ = ["GracefulShutdown", "MetricLogger", "Trainer", "resume",
           "summary_writer_class"]


class GracefulShutdown:
    """SIGTERM/SIGINT -> finish the in-flight step, checkpoint, exit clean.

        with GracefulShutdown() as stop:
            for step in ...:
                trainer.step(batch)
                if stop.requested:
                    trainer.save_checkpoint(log_dir, last_only=True)
                    break
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = signals
        self.requested = False
        self._prev = {}

    def _handler(self, signum, frame):
        self.requested = True

    def __enter__(self):
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        return False


def summary_writer_class():
    """``torch.utils.tensorboard.SummaryWriter``; raises ImportError when
    the ``tensorboard`` package is absent.  (JAX's logger drops TensorBoard
    quietly then; the port's CLIs call this at start and fail instead.)"""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise ImportError("--use_tensorboard 1 needs the tensorboard package, which is not "
                          "importable here") from e
    return SummaryWriter


class MetricLogger:
    """Appends one JSON line per ``log`` call to ``log_dir/metrics.jsonl``
    and, with ``use_tensorboard``, writes the same scalars to a TensorBoard
    event file in ``log_dir`` through ``tb`` (reference engine.py:28-29,
    main_keypose.py:232-234)."""

    def __init__(self, log_dir: Path, use_tensorboard: bool = False):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.tb = summary_writer_class()(log_dir=str(self.log_dir)) if use_tensorboard else None
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")

    def log(self, step: int, metrics: Dict[str, float]):
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(k, float(v), step)

    def close(self):
        self._jsonl.close()
        if self.tb is not None:
            self.tb.close()


class Trainer:
    """Trainer of one model on one device.

    Args:
      loss_fn: (batch, generators) -> (scalar loss, aux dict); called with
        the model in training mode.
      model: the module; its backbone is frozen by :func:`make_optimizer`.
      metrics_fn: optional (batch, generators) -> dict of scalars for eval.
      lr / weight_decay: AdamW (reference defaults 1e-4, 5e-4).
      accumulate_grad_batches: micro-batches averaged per optimizer step.
      seed: of the :class:`Generators` that drive dropout and noise.
      use_tensorboard: the logger also writes TensorBoard events.
    """

    def __init__(
        self,
        loss_fn: Callable,
        model: nn.Module,
        *,
        metrics_fn: Optional[Callable] = None,
        lr: float = 1e-4,
        weight_decay: float = 5e-4,
        accumulate_grad_batches: int = 1,
        log_dir: Optional[Path] = None,
        seed: int = 0,
        use_tensorboard: bool = False,
    ):
        self.model = model
        self.optimizer = make_optimizer(model, lr=lr, weight_decay=weight_decay)
        self.accumulator = GradientAccumulator(self.optimizer, accumulate_grad_batches)
        device = next(model.parameters()).device
        self.generators = Generators.from_seed(seed, device)
        self.step_count = 0
        self.best_loss: Optional[float] = None
        self._loss_fn = loss_fn
        self._metrics_fn = metrics_fn
        self.logger = MetricLogger(log_dir, use_tensorboard) if log_dir else None

    def step(self, batch) -> Dict[str, torch.Tensor]:
        """One micro-batch: loss, backward, and an optimizer step every
        ``accumulate_grad_batches`` calls.  The loss comes back as a device
        tensor (no sync)."""
        self.model.train()
        loss, aux = self._loss_fn(batch, self.generators)
        loss.backward()
        self.accumulator.step()
        self.step_count += 1
        return {"loss": loss.detach(), **(aux or {})}

    def eval_step(self, batch) -> Dict[str, torch.Tensor]:
        """The metrics of one batch as ``metrics_fn`` returns them
        (per-sample or scalar tensors), in eval mode without grad."""
        if self._metrics_fn is None:
            raise ValueError("no metrics_fn provided")
        self.model.eval()
        with torch.no_grad():
            return self._metrics_fn(batch, self.generators)

    def evaluate(self, batches: Iterable) -> Dict[str, float]:
        """Average eval metrics over batches, in eval mode without grad."""
        sums: Dict[str, float] = {}
        count = 0
        for batch in batches:
            for k, v in self.eval_step(batch).items():
                sums[k] = sums.get(k, 0.0) + float(torch.as_tensor(v).float().mean())
            count += 1
        return {k: v / max(count, 1) for k, v in sums.items()}

    # ------------------------------------------------------- checkpointing
    def save_checkpoint(self, ckpt_dir: Path, new_loss: Optional[float] = None, *,
                        last_only: bool = False):
        """best/last semantics of the reference (engine.py:214-230).

        ``last_only=True`` writes only the resumable ``last.pt``; otherwise
        ``best.pt`` is replaced when ``new_loss <= best_loss`` (or when
        either is None: the always-overwrite mode).
        """
        ckpt_dir = Path(ckpt_dir)
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        if not last_only and (new_loss is None or self.best_loss is None
                              or new_loss <= self.best_loss):
            self.best_loss = new_loss
            torch.save(self._payload(), ckpt_dir / "best.pt")
        torch.save(self._payload(), ckpt_dir / "last.pt")

    def _payload(self):
        return {
            "model": self.model.state_dict(),
            "optimizer": self.accumulator.state_dict(),
            "step": self.step_count,
            "best_loss": self.best_loss,
        }

    def load_checkpoint(self, path: Path):
        payload = torch.load(Path(path), map_location=next(self.model.parameters()).device,
                             weights_only=True)
        self.model.load_state_dict(payload["model"])
        self.accumulator.load_state_dict(payload["optimizer"])
        self.step_count = payload["step"]
        self.best_loss = payload["best_loss"]


def resume(trainer: Trainer, log_dir: Path, checkpoint: Optional[str] = None,
           auto_resume: bool = True) -> Optional[Path]:
    """Load ``checkpoint`` if given, else ``log_dir/last.pt`` when
    ``auto_resume`` and it exists (a relaunch with the same command line
    goes on from the last checkpoint).  Returns the path loaded, or None."""
    path = Path(checkpoint) if checkpoint else Path(log_dir) / "last.pt"
    if not checkpoint and not (auto_resume and path.exists()):
        return None
    print(f"Resuming from {path}")
    trainer.load_checkpoint(path)
    return path
