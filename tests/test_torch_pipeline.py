"""The port's multi-process shared-memory sampler (``data/pipeline.py``).

As JAX's tests/test_pipeline.py: shapes and dtypes of the probe, the
batches of the worker with factory seed s equal to an in-process dataset
at seed base + 1000 (s + 1) (and to JAX's dataset at that seed), zero-copy views that outlive
``close()``, a stalled worker that does not wedge the parent; and, new in
the port: workers that compact-encode their batches, a worker's exception
raised by ``__next__``, the death of every worker raised instead of a hang,
``copy=False`` views through the DeviceFeeder, and the fork server and
resource tracker stopped so that no process outlives the caller.  Workers
start through forkserver, so every dataset class here is module-level
(picklable by reference).  Every test uses at most 2 workers and bounded
waits.
"""

import functools
import os
import time

import numpy as np
import pytest
import torch

from act3d_tpu_torch.data.compact import compact_batch
from act3d_tpu_torch.data.feeder import DeviceFeeder
from act3d_tpu_torch.data.fixtures import make_dataset_tree, make_instructions
from act3d_tpu_torch.data.pipeline import (
    MultiProcessSampler,
    WorkerError,
    _build_rlbench_dataset,
    rlbench_dataset_factory,
    stop_helper_processes,
)

BASE_SEED = 5


@pytest.fixture(scope="module")
def kwargs(tmp_path_factory):
    root = make_dataset_tree(tmp_path_factory.mktemp("episodes"), tasks=("pick_and_lift",),
                             variations=(0,), episodes_per_variation=2, n_frames=3, n_cam=2,
                             image_size=16)
    return dict(root=root, instructions=make_instructions(("pick_and_lift",), (0,)),
                taskvar=[("pick_and_lift", 0)], cameras=("wrist", "left_shoulder"),
                cache_size=10, training=True, image_rescale=(0.75, 1.25),
                return_low_lvl_trajectory=True, dense_interpolation=True,
                interpolation_length=8, seed=123)


def _same(a, b):
    return all(np.array_equal(a[k], b[k]) for k in b if k != "task") and a["task"] == b["task"]


@pytest.mark.parametrize("compact", [False, True], ids=["f32", "compact"])
def test_workers_give_the_in_process_streams_of_their_seeds(kwargs, compact):
    from act3d_tpu.data.dataset import RLBenchDataset as JaxDataset

    factory = rlbench_dataset_factory(kwargs, BASE_SEED, compact)
    probe = factory(0).sample_batch(3)
    assert probe["rgbs"].dtype == (np.uint8 if compact else np.float32)
    streams = {w: _build_rlbench_dataset(kwargs, BASE_SEED, False, w + 1) for w in (0, 1)}
    jax_stream = JaxDataset(**{**kwargs, "seed": BASE_SEED + 1000 * 3})
    expected = {w: [ds.sample_batch(3) for _ in range(8)] for w, ds in streams.items()}
    for batch in expected[1][:3]:  # worker 1's stream is JAX's at its seed
        assert _same(batch, jax_stream.sample_batch(3))
    if compact:  # the workers encode what the parent would have
        expected = {w: [compact_batch(b) for b in bs] for w, bs in expected.items()}
    with MultiProcessSampler(factory, batch_size=3, num_workers=2,
                             slots_per_worker=2) as sampler:
        got = [next(sampler) for _ in range(8)]
    pos = {0: 0, 1: 0}
    for batch in got:
        for key, val in probe.items():
            if isinstance(val, np.ndarray):
                assert batch[key].shape == val.shape and batch[key].dtype == val.dtype, key
        # each batch is the next one of a worker's stream, in that worker's order
        w = next(w for w in (0, 1) if _same(batch, expected[w][pos[w]]))
        pos[w] += 1
    assert sum(pos.values()) == 8


def test_zero_copy_views_survive_close(kwargs):
    sampler = MultiProcessSampler(rlbench_dataset_factory(kwargs, BASE_SEED), batch_size=2,
                                  num_workers=1, slots_per_worker=2, copy=False)
    a = next(sampler)
    b = next(sampler)  # a's slot is recycled now, not before
    assert b["rgbs"].shape == a["rgbs"].shape and np.isfinite(b["rgbs"]).all()
    checksum = float(np.sum(b["rgbs"]))
    sampler.close()
    assert float(np.sum(b["rgbs"])) == checksum  # still mapped, unchanged


class _CounterDataset:
    """Batch i of a worker is filled with 1000 * seed + i."""

    def __init__(self, seed):
        self.seed, self.i = seed, 0

    def sample_batch(self, n):
        self.i += 1
        return {"x": np.full((n, 64), 1000 * self.seed + self.i, np.int32),
                "flag": np.full((n,), self.i % 2 == 0), "task": [f"t{self.seed}"] * n}


def test_the_feeder_copies_zero_copy_views_before_they_are_recycled():
    with MultiProcessSampler(_CounterDataset, batch_size=4, num_workers=2, slots_per_worker=1,
                             copy=False) as sampler:
        feeder = DeviceFeeder(lambda: next(sampler), device="cpu")
        seen = []
        try:
            for _ in range(10):
                batch = next(feeder)
                time.sleep(0.01)  # let the workers refill the recycled slots
                x = batch["x"]
                assert x.dtype == torch.int32 and bool((x == x[0, 0]).all()), x
                assert batch["flag"].dtype == torch.bool
                seen.append(int(x[0, 0]))
        finally:
            feeder.close()
        assert not feeder._thread.is_alive()
    for s in (1, 2):  # each worker's counters arrive in order
        mine = [v - 1000 * s for v in seen if v // 1000 == s]
        assert mine == sorted(mine)


class _StallDataset:
    """Worker seed 1 stalls; any other serves at once."""

    def __init__(self, seed):
        self.stall = seed == 1

    def sample_batch(self, n):
        if self.stall:
            time.sleep(3600)
        return {"x": np.full((n, 4), 7, np.int64)}


def test_a_stalled_worker_does_not_wedge_the_parent():
    sampler = MultiProcessSampler(_StallDataset, batch_size=2, num_workers=2,
                                  slots_per_worker=2)
    try:
        t0 = time.monotonic()
        for _ in range(5):
            assert int(next(sampler)["x"][0, 0]) == 7
        assert time.monotonic() - t0 < 30.0
    finally:
        sampler.close()  # terminates the stalled worker after the join timeout


class _RaisingDataset:
    """Worker seed 2 raises at its second batch; the probe (seed 0) serves."""

    def __init__(self, seed):
        self.seed, self.n = seed, 0

    def sample_batch(self, n):
        self.n += 1
        if self.seed == 2 and self.n == 2:
            raise KeyError("episode 17 is missing")
        if self.seed == 1:
            time.sleep(0.05)
        return {"x": np.zeros((n,), np.float32)}


def test_a_worker_exception_is_raised_by_next():
    sampler = MultiProcessSampler(_RaisingDataset, batch_size=2, num_workers=2)
    try:
        t0 = time.monotonic()
        with pytest.raises(WorkerError, match="episode 17 is missing") as err:
            for _ in range(50):
                next(sampler)
        assert "worker 2 failed" in str(err.value) and "KeyError" in str(err.value)
        assert time.monotonic() - t0 < 30.0
    finally:
        sampler.close()


class _DyingDataset:
    """Every worker exits without a word at its first batch."""

    def __init__(self, seed):
        self.seed = seed

    def sample_batch(self, n):
        if self.seed:
            os._exit(3)
        return {"x": np.zeros((n,), np.float32)}


def test_the_death_of_every_worker_is_raised_not_waited_for():
    sampler = MultiProcessSampler(_DyingDataset, batch_size=2, num_workers=2)
    try:
        t0 = time.monotonic()
        with pytest.raises(WorkerError, match=r"every worker has exited \(exit codes \[3, 3\]\)"):
            next(sampler)
        assert time.monotonic() - t0 < 30.0
    finally:
        sampler.close()


def test_factory_is_picklable_and_seeds_each_worker():
    import pickle

    factory = rlbench_dataset_factory({"root": "/nonexistent"}, 7)
    again = pickle.loads(pickle.dumps(factory))
    assert isinstance(again, functools.partial)
    assert again.args == ({"root": "/nonexistent"}, 7, False)


def test_stop_helper_processes_leaves_no_process_and_samplers_start_again(kwargs):
    from multiprocessing import forkserver, resource_tracker

    factory = rlbench_dataset_factory(kwargs, BASE_SEED)
    for _ in range(2):  # the second sampler starts both helpers anew
        with MultiProcessSampler(factory, batch_size=2, num_workers=2) as sampler:
            assert next(sampler)["rgbs"].shape[0] == 2
        sampler.close()  # a second close is a no-op
        helpers = [forkserver._forkserver._forkserver_pid,
                   resource_tracker._resource_tracker._pid]
        assert None not in helpers
        stop_helper_processes()
        for pid in helpers:  # exited and reaped
            with pytest.raises(ChildProcessError):
                os.waitpid(pid, os.WNOHANG)
