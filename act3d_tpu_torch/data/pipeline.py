"""Multi-process batch assembly over shared memory, the port of
``act3d_tpu/data/pipeline.py``.

The counterpart of the reference's multi-worker DataLoader (reference:
engine.py:51-62).  Each worker process owns a dataset (its own episode
cache and RNG stream) and assembles whole fixed-shape batches straight
into preallocated ``multiprocessing.shared_memory`` slots; the parent hands
out free slots and receives ready ones through queues, so the parent pays
one memcpy per batch (none with ``copy=False``).

Workers start through **forkserver** (spawn where there is none), never
fork: the parent holds a CUDA context and threads, and a forked child can
deadlock on a lock another thread held.  So ``dataset_factory`` must be
picklable (a module-level function or a ``functools.partial`` over one),
and workers never touch CUDA.  The fork server preloads ``__main__`` (so an
entry point must do no work at import) and ``act3d_tpu_torch.data.dataset``,
which imports ``torch`` through the package's ``__init__``: the server pays
that import once and the workers fork from it.

The probe batch that fixes the slots' layout is drawn in the parent before
any worker starts; it also builds the native blosc decoder
(``native/__init__.py``), so the workers find it built.

A worker's exception reaches the parent and is raised by ``__next__``, as
is the death of every worker; the parent never blocks forever.

Layering: MultiProcessSampler (host batches) -> DeviceFeeder (pinned copy,
H2D) -> the training step.
"""

from __future__ import annotations

import functools
import gc
import multiprocessing as mp
import queue
import traceback
from multiprocessing import shared_memory
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np

__all__ = ["MultiProcessSampler", "WorkerError", "rlbench_dataset_factory",
           "stop_helper_processes"]

_SENTINEL = -1
_DATASET_MODULE = __name__.rpartition(".")[0] + ".dataset"
POLL_SECONDS = 1.0  # how often a waiting __next__ checks that a worker lives
JOIN_SECONDS = 5.0

# Segments whose mapping must outlive their sampler because a copy=False
# consumer may still hold zero-copy views into them at close() (see
# MultiProcessSampler.close): kept for the process lifetime rather than
# unmapped under live arrays.
_UNCLOSED: List[shared_memory.SharedMemory] = []


def stop_helper_processes() -> None:
    """Stop the fork server and the resource tracker that the first sampler
    started, and wait for both to exit.

    Left alone, each outlives this process by seconds: the fork server,
    which holds torch, exits only once it sees this process gone.  A
    program that must leave no process behind when it returns calls this
    after closing every sampler; a later sampler starts both anew.
    """
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    gc.collect()  # the tracker unlinks every semaphore still registered
    resource_tracker._resource_tracker._stop()


class WorkerError(RuntimeError):
    """A worker process failed; the message holds its traceback."""


class _CompactBatches:
    """A dataset whose batches come ``compact_batch``-encoded."""

    def __init__(self, dataset):
        self._dataset = dataset

    def sample_batch(self, batch_size: int):
        from .compact import compact_batch

        return compact_batch(self._dataset.sample_batch(batch_size))


def _build_rlbench_dataset(dataset_kwargs, base_seed, compact, seed):
    from .dataset import RLBenchDataset

    dataset = RLBenchDataset(**{**dataset_kwargs, "seed": base_seed + 1000 * (seed + 1)})
    return _CompactBatches(dataset) if compact else dataset


def rlbench_dataset_factory(dataset_kwargs: dict, base_seed: int, compact: bool = False):
    """Picklable worker-dataset factory: factory seed ``s`` gives dataset
    seed ``base_seed + 1000 * (s + 1)``, as JAX's.  The parent's probe is
    s = 0 and worker w (from 0) is s = w + 1, so each process has its own
    sampling and augmentation stream.  With ``compact`` the workers also
    run ``compact_batch`` (u8 rgbs, u16 pcds and depth), which JAX's CLIs
    run in the parent's feeder thread: the same bytes, off the parent, and
    slots 2.6x smaller."""
    return functools.partial(_build_rlbench_dataset, dict(dataset_kwargs), base_seed,
                             bool(compact))


def _views_from_shm(shm, schema) -> Dict[str, np.ndarray]:
    views, offset = {}, 0
    for key, (shape, dtype) in schema.items():
        views[key] = np.ndarray(shape, dtype, buffer=shm.buf, offset=offset)
        offset += int(np.prod(shape)) * np.dtype(dtype).itemsize
    return views


def _worker_loop(factory, seed, batch_size, schema, shm_names, free_q, ready_q):
    shms = {}
    try:
        dataset = factory(seed)
        shms = {i: shared_memory.SharedMemory(name=n) for i, n in shm_names.items()}
        views = {i: _views_from_shm(shm, schema) for i, shm in shms.items()}
        while True:
            slot = free_q.get()
            if slot == _SENTINEL:
                break
            batch = dataset.sample_batch(batch_size)
            aux = {}
            for key, arr in batch.items():
                if key in views[slot]:
                    np.copyto(views[slot][key], arr, casting="same_kind")
                else:  # non-array values (task names) go by pickle
                    aux[key] = arr
            ready_q.put((slot, aux))
    except (KeyboardInterrupt, EOFError, BrokenPipeError):
        pass
    except Exception:  # handed to the parent, raised by __next__
        ready_q.put((None, f"worker {seed} failed:\n{traceback.format_exc()}"))
    finally:
        for shm in shms.values():
            shm.close()


class MultiProcessSampler:
    """Iterator of host batches assembled by worker processes.

    Args:
      dataset_factory: seed -> dataset with ``sample_batch(batch_size)``;
        called with 0 in the parent (the probe that fixes the slot layout)
        and with w + 1 in worker w.  Must be picklable.
      batch_size: samples per batch.
      num_workers: worker processes.
      slots_per_worker: shared-memory batches in flight per worker.
      copy: True (default): ``__next__`` returns fresh arrays and recycles
        the slot at once.  False: it returns zero-copy views into the slot,
        recycled at the following ``__next__``; the consumer must be done
        with a batch (copied it out, e.g. into pinned memory) before it asks
        for the next, and should drop every view by ``close()``: segments
        still viewed then stay mapped for the process lifetime (their names
        are unlinked at once).
    """

    def __init__(self, dataset_factory: Callable[[int], object], batch_size: int,
                 num_workers: int = 2, slots_per_worker: int = 2, copy: bool = True):
        probe = dataset_factory(0).sample_batch(batch_size)
        self._schema: Dict[str, Tuple[tuple, np.dtype]] = {
            k: (v.shape, v.dtype) for k, v in probe.items() if isinstance(v, np.ndarray)}
        nbytes = sum(int(np.prod(s)) * np.dtype(d).itemsize for s, d in self._schema.values())

        try:
            ctx = mp.get_context("forkserver")
            # the server imports the dataset module (torch with it) once and
            # each worker forks from it: unpickling a factory no longer
            # imports torch in every worker, while start() waits for it
            ctx.set_forkserver_preload(["__main__", _DATASET_MODULE])
        except ValueError:  # a platform without forkserver
            ctx = mp.get_context("spawn")
        self._copy = copy
        self._handed_out_views = False
        self._pending_recycle = None
        self._free_q = ctx.Queue()
        self._ready_q = ctx.Queue()
        self._shms = [shared_memory.SharedMemory(create=True, size=max(nbytes, 1))
                      for _ in range(num_workers * slots_per_worker)]
        self._views = {i: _views_from_shm(s, self._schema) for i, s in enumerate(self._shms)}
        for i in range(len(self._shms)):
            self._free_q.put(i)
        shm_names = {i: s.name for i, s in enumerate(self._shms)}
        self._procs = []
        for w in range(num_workers):
            p = ctx.Process(target=_worker_loop, daemon=True,
                            args=(dataset_factory, w + 1, batch_size, self._schema,
                                  shm_names, self._free_q, self._ready_q))
            p.start()
            self._procs.append(p)

    def __iter__(self) -> Iterator[dict]:
        return self

    def _get_ready(self):
        while True:
            try:
                return self._ready_q.get(timeout=POLL_SECONDS)
            except queue.Empty:
                if not any(p.is_alive() for p in self._procs):
                    try:  # a last item may have landed as the workers exited
                        return self._ready_q.get(timeout=POLL_SECONDS)
                    except queue.Empty:
                        codes = [p.exitcode for p in self._procs]
                        raise WorkerError(f"every worker has exited (exit codes {codes})")

    def __next__(self) -> dict:
        if not self._procs:
            raise StopIteration
        if self._pending_recycle is not None:
            self._free_q.put(self._pending_recycle)
            self._pending_recycle = None
        slot, aux = self._get_ready()
        if slot is None:
            raise WorkerError(aux)
        views = self._views[slot]
        if self._copy:
            batch = {k: v.copy() for k, v in views.items()}
            self._free_q.put(slot)
        else:
            batch = dict(views)
            self._pending_recycle = slot
            self._handed_out_views = True
        batch.update(aux)
        return batch

    def close(self):
        """Stop the workers (terminated after ``JOIN_SECONDS`` if they do not
        exit) and release the shared memory (module docstring, ``copy``)."""
        if self._free_q is None:  # closed already
            return
        for _ in self._procs:
            self._free_q.put(_SENTINEL)
        for p in self._procs:
            p.join(JOIN_SECONDS)
            if p.is_alive():
                p.terminate()
                p.join(JOIN_SECONDS)
        self._procs = []
        # the parent only puts slot numbers, a few bytes each and never more
        # than the slots, so the free queue's feeder thread cannot block on
        # a full pipe: join it; dropping both queues then frees their
        # semaphores (stop_helper_processes needs none left)
        for q in (self._free_q, self._ready_q):
            q.close()
        self._free_q.join_thread()
        self._free_q = self._ready_q = None
        # numpy keeps no buffer export open, so shm.close() would unmap
        # under a live copy=False view: keep those mappings for the
        # process lifetime and free only the names
        self._views = {}
        self._pending_recycle = None
        leak = not self._copy and self._handed_out_views
        for s in self._shms:
            try:
                s.unlink()
            except FileNotFoundError:
                pass
            if leak:
                _UNCLOSED.append(s)
            else:
                s.close()
        self._shms = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
