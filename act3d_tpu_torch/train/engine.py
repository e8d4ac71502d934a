"""Training engine: steps, evaluation, checkpoints, logging.

Counterpart of ``act3d_tpu/train/engine.py``: the loss and its backward
run eagerly (the attention cores through the fused kernels) or, where
:meth:`Trainer.graphable` holds, replay from a CUDA graph of the batch's
tensors (``train/step_graph.py``); AdamW (``optim.py``) steps the
trainable params eagerly, and checkpoints keep
JAX's best/last semantics in ``best.pt`` / ``last.pt`` (JAX writes
``.msgpack``); :func:`resume` is the CLIs' ``--checkpoint`` /
``--auto_resume``.  With a mesh (``parallel/mesh.py``) each rank steps its
rows of the global batch through DDP (``("dp",)``) or FSDP2 (``("dp",
"fsdp")``), evaluation averages over the ranks, and checkpoints are
gathered to the one-device layout and written by rank 0.
"""

from __future__ import annotations

import json
import signal
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import torch
import torch.distributed
import torch.nn as nn

from ..device import graph_stream, on_stream
from ..nn.dropout import Generators
from ..parallel import mesh as pmesh
from ..parallel.collectives import all_gather_metrics
from .optim import GradientAccumulator, freeze_backbone, make_optimizer
from .step_graph import ENTRIES, TrainStepGraphs, batch_key
from ..utils.spans import span

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


class _Runner(nn.Module):
    """The module the data-parallel wrappers wrap: ``forward(fn, *args,
    **kwargs)`` is ``fn(*args, **kwargs)``, a loss, metric or sampling
    function that calls ``model``, so that every use of the model enters
    through the wrapper (DDP's gradient hooks, FSDP2's root all-gather)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn, *args, **kwargs):
        return fn(*args, **kwargs)


def _hooked(module: nn.Module) -> bool:
    """Whether a forward, pre-forward or backward hook is registered on
    any submodule of ``module`` or globally."""
    from torch.nn.modules import module as mod

    kinds = ("_forward_hooks", "_forward_pre_hooks", "_backward_hooks", "_backward_pre_hooks")
    return (any(getattr(mod, "_global" + kind, None) for kind in kinds)
            or any(getattr(m, kind, None) for m in module.modules() for kind in kinds))


class Trainer:
    """Trainer of one model on one device or over a mesh of ranks.

    Args:
      loss_fn: (batch, generators) -> (scalar loss, aux dict); called with
        the model in training mode.
      model: the unwrapped module; its backbone is frozen before it is
        wrapped.
      metrics_fn: optional (batch, generators) -> dict of scalars for eval.
      lr / weight_decay: AdamW (reference defaults 1e-4, 5e-4).
      accumulate_grad_batches: micro-batches averaged per optimizer step.
      log_dir: the logger's directory (rank 0 logs).
      seed: of the :class:`Generators` that drive dropout and noise; every
        rank seeds them alike and draws at the global batch.
      use_tensorboard: the logger also writes TensorBoard events.
      mesh: None (one device) or the mesh of ``parallel.mesh.make_mesh``;
        the batches given to :meth:`step` and :meth:`eval_step` are then
        this rank's rows of the global batch.
      compute_dtype: the dtype the loss function computes in (its
        ``compute_dtype``); under FSDP2 the sharded parameters are gathered
        in it.

    Counters over every Trainer of the process: ``Trainer.eager_steps``,
    ``.replayed_steps`` (steps whose forward and backward replayed a CUDA
    graph, a step that captured one included) and ``.captures``.
    """

    eager_steps = 0
    replayed_steps = 0
    captures = 0

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
        mesh=None,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        self.model = model
        self.mesh = mesh
        self.rank, self.world = (mesh.get_rank(), mesh.size()) if mesh is not None else (0, 1)
        device = next(model.parameters()).device
        self._stream = graph_stream(device)
        self.runner = pmesh.shard_module(_Runner(freeze_backbone(model)), mesh, compute_dtype)
        # after sharding: FSDP2 replaces the parameters by DTensors
        self.optimizer = make_optimizer(model, lr=lr, weight_decay=weight_decay)
        self.accumulator = GradientAccumulator(self.optimizer, accumulate_grad_batches)
        self.graphs = TrainStepGraphs(p for p in model.parameters() if p.requires_grad)
        self._warm = False  # an eager step has run: kernels loaded, AdamW's state made
        self.generators = Generators.from_seed(seed, device, self.rank, self.world)
        self.step_count = 0
        self.best_loss: Optional[float] = None
        self._loss_fn = loss_fn
        self._metrics_fn = metrics_fn
        self.logger = (MetricLogger(log_dir, use_tensorboard)
                       if log_dir and self.rank == 0 else None)

    def step(self, batch) -> Dict[str, torch.Tensor]:
        """One micro-batch: loss, backward, and an optimizer step every
        ``accumulate_grad_batches`` calls.  The loss comes back as a device
        tensor (no sync).  On a CUDA device the step runs on
        ``device.py::graph_stream``.  Where :meth:`graphable` holds, the
        loss and its backward replay from the CUDA graph of the batch's
        tensors, captured where the same tensors came within the last
        ``step_graph.SEEN`` steps, while fewer than ``ENTRIES`` graphs
        exist; a batch whose capture raises runs eagerly from then on.
        Spans: "train.step" around it; in an eager step "train.forward",
        "train.backward" and "train.optimizer" inside."""
        with span("train.step"), on_stream(self._stream):
            self.runner.train()
            key = batch_key(batch) if self._stream is not None else None
            again = self.graphs.sighted(key)
            out = self._graph_step(key, batch) if again and self.graphable() else None
            if out is None:
                out = self._eager_step(batch)
                Trainer.eager_steps += 1
                self._warm = True
            else:
                self.accumulator.step()
                Trainer.replayed_steps += 1
            self.step_count += 1
            return out

    def graphable(self) -> bool:
        """Whether the next step may replay a CUDA graph: a CUDA device, no
        mesh, no accumulation, an eager step done (kernels loaded, cuBLAS
        warm, AdamW's state made) and no forward, pre-forward or backward
        hook on the model, whose Python a replay would skip."""
        return (self._stream is not None and self.mesh is None
                and self.accumulator.every_k == 1 and self._warm
                and not _hooked(self.runner))

    def _eager_step(self, batch) -> Dict[str, torch.Tensor]:
        steps = self.accumulator.count + 1 == self.accumulator.every_k
        with pmesh.set_gradient_sync(self.runner, steps):
            with span("train.forward"):
                loss, aux = self.runner(self._loss_fn, batch, self.generators)
            with span("train.backward"):
                loss.backward()
        with span("train.optimizer"):
            self.accumulator.step()
        return {"loss": loss.detach(), **(aux or {})}

    def _graph_step(self, key, batch) -> Optional[Dict[str, torch.Tensor]]:
        """The step's outputs from a replay of ``key``'s graph, after its
        capture where it has none; None where it runs eagerly."""
        if key not in self.graphs:
            if len(self.graphs) >= ENTRIES:
                return None

            def forward_backward(generators):
                loss, aux = self.runner(self._loss_fn, batch, generators)
                loss.backward()
                return loss, aux

            if self.graphs.capture(key, forward_backward, self.generators):
                Trainer.captures += 1
        return self.graphs.replay(key, self.generators)

    def eval_step(self, batch) -> Dict[str, torch.Tensor]:
        """The metrics of one batch as ``metrics_fn`` returns them
        (per-sample or scalar tensors), in eval mode without grad."""
        if self._metrics_fn is None:
            raise ValueError("no metrics_fn provided")
        self.runner.eval()
        with torch.no_grad():
            return self.runner(self._metrics_fn, batch, self.generators)

    def evaluate(self, batches: Iterable) -> Dict[str, float]:
        """Average eval metrics over batches, in eval mode without grad, and
        over the ranks (each rank's batch mean is over the same number of
        rows, so their mean is the global batch's)."""
        sums: Dict[str, float] = {}
        count = 0
        for batch in batches:
            for k, v in self.eval_step(batch).items():
                sums[k] = sums.get(k, 0.0) + float(torch.as_tensor(v).float().mean())
            count += 1
        ranks = all_gather_metrics(sums)
        return {k: sum(r[k] for r in ranks) / (len(ranks) * max(count, 1)) for k in sums}

    # ------------------------------------------------------- checkpointing
    def save_checkpoint(self, ckpt_dir: Path, new_loss: Optional[float] = None, *,
                        last_only: bool = False):
        """best/last semantics of the reference (engine.py:214-230).

        ``last_only=True`` writes only the resumable ``last.pt``; otherwise
        ``best.pt`` is replaced when ``new_loss <= best_loss`` (or when
        either is None: the always-overwrite mode).  Every rank calls it
        with the same ``new_loss`` (sharded state is gathered); rank 0
        writes.
        """
        best = not last_only and (new_loss is None or self.best_loss is None
                                  or new_loss <= self.best_loss)
        if best:
            self.best_loss = new_loss
        payload = self._payload()
        if self.rank == 0:
            ckpt_dir = Path(ckpt_dir)
            ckpt_dir.mkdir(parents=True, exist_ok=True)
            if best:
                torch.save(payload, ckpt_dir / "best.pt")
            torch.save(payload, ckpt_dir / "last.pt")
        if self.world > 1:  # no rank reads the files before rank 0 has written them
            torch.distributed.barrier(group=pmesh.host_group())

    def _payload(self):
        """The one-device layout whatever the mesh: no wrapper prefix, no
        DTensor (``parallel.mesh.full_state_dict``)."""
        return {
            "model": pmesh.full_state_dict(self.model),
            "optimizer": self.accumulator.state_dict(),
            "step": self.step_count,
            "best_loss": self.best_loss,
        }

    def load_checkpoint(self, path: Path):
        """Load a checkpoint written on any mesh: every rank reads the file
        and keeps its shards.  Drops every CUDA graph of the step."""
        self.graphs.clear()
        payload = torch.load(Path(path), map_location=next(self.model.parameters()).device,
                             weights_only=True)
        pmesh.load_full_state_dict(self.model, payload["model"])
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
