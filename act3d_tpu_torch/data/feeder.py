"""Double-buffered host -> device batch feed.

The port's counterpart of ``act3d_tpu/data/feeder.py`` (JAX's
``device_put`` prefetch thread), replacing the reference's DataLoader +
``pin_memory`` (reference: engine.py:51-62).  A background thread builds
the next host batch, copies its arrays into pinned host tensors and starts
``non_blocking`` copies to the card on a side CUDA stream, so batch
assembly and the host -> device transfer overlap the training step.

Memory safety, since a fault here gives wrong batches and no crash:
  * each pinned staging tensor comes from PyTorch's caching host
    allocator, which does not reuse a block before the copy that reads it
    has completed; the thread also waits for the side stream's event
    before it queues the batch, so a queued batch has landed on the card;
  * ``__next__`` makes the caller's current stream wait on that event and
    calls ``record_stream`` on every tensor it hands out, so the caching
    device allocator does not reuse a batch's memory (allocated on the side
    stream) while the caller's stream may still read it.
List-valued keys (``task``) pass through.  On the CPU the arrays become
plain tensors.  An exception in ``batch_fn`` is raised again by
``__next__``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np
import torch

__all__ = ["DeviceFeeder", "to_tensors"]

PREFETCH = 2  # batches built ahead of the consumer, as JAX's feeder
JOIN_SECONDS = 60.0


def to_tensors(batch: dict, device) -> dict:
    """A host batch as tensors on ``device`` (blocking copies); list-valued
    keys pass through."""
    return {k: v if isinstance(v, list)
            else torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class DeviceFeeder:
    def __init__(self, batch_fn: Callable[[], dict], device="cuda"):
        """batch_fn: returns the next host batch (a dict of numpy arrays and
        lists); up to ``PREFETCH`` batches wait in the queue."""
        self._batch_fn = batch_fn
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if self._cuda else None
        self._q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _to_device(self, batch: dict):
        if not self._cuda:
            return to_tensors(batch, self._device), None
        out: Dict[str, object] = {}
        with torch.cuda.stream(self._stream):
            for k, v in batch.items():
                if isinstance(v, list):
                    out[k] = v
                    continue
                pinned = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                out[k] = pinned.to(self._device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        event.synchronize()  # the batch has landed before it is queued
        return out, event

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def _worker(self):
        try:
            while not self._stop.is_set():
                self._put(self._to_device(self._batch_fn()))
        except Exception as e:  # handed to the consumer by __next__
            self._put(e)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for v in batch.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(stream)
        return batch

    def close(self) -> None:
        """Stop the thread (it finishes the batch it is building, for at
        most ``JOIN_SECONDS``) and drop the queued batches."""
        self._stop.set()
        self._drain()
        self._thread.join(JOIN_SECONDS)
        self._drain()

    def _drain(self):
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
