"""Faults planted in the system under test, for reading what the check
gives when the timed path is broken (benchmark/tests/test_bench_faults.py
on the CPU; ``calibrate.py --fault`` on the card at a cell's own size).
Each is a context manager that patches the system and undoes the patch on
exit.  The benchmark's own runs never plant one."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, replacement):
    sound = getattr(module, name)
    setattr(module, name, replacement(sound))
    try:
        yield
    finally:
        setattr(module, name, sound)


def altered_trajectory():
    """An answer altered where it is produced: 1 cm added to the last
    point's x of every trajectory the sampler returns."""
    from act3d_tpu_torch.eval import actioner

    def wrap(sound):
        def altered(*args, **kwargs):
            traj = sound(*args, **kwargs)
            traj[:, -1, 0] += 1e-2
            return traj
        return altered

    return _patched(actioner, "compute_trajectory", wrap)


def state_unchanged():
    """A step that returns its state unchanged: the optimizer never steps."""
    from act3d_tpu_torch.train import optim

    def wrap(sound):
        def no_step(self):
            self.optimizer.zero_grad(set_to_none=True)
            return True
        return no_step

    return _patched(optim.GradientAccumulator, "step", wrap)


def state_unchanged_after_warmup(sound_calls: int = 3):
    """A step that is sound for the process's first ``sound_calls`` steps
    (a set-up's warm-up) and afterwards returns its state unchanged: a plan
    or a cached graph that takes effect only once warmed."""
    from act3d_tpu_torch.train import optim

    calls = [0]

    def wrap(sound):
        def step(self):
            calls[0] += 1
            if calls[0] <= sound_calls:
                return sound(self)
            self.optimizer.zero_grad(set_to_none=True)
            return True
        return step

    return _patched(optim.GradientAccumulator, "step", wrap)


def half_batch():
    """Half of the batch left out, the mean taken over the rest."""
    from act3d_tpu_torch.train import flagship

    def wrap(sound):
        def half(batch, *args, **kwargs):
            batch = sound(batch, *args, **kwargs)
            return {k: v[: v.shape[0] // 2] if torch.is_tensor(v) else v
                    for k, v in batch.items()}
        return half

    return _patched(flagship, "canonical_batch", wrap)


FAULTS = {"altered_trajectory": altered_trajectory, "state_unchanged": state_unchanged,
          "state_unchanged_after_warmup": state_unchanged_after_warmup,
          "half_batch": half_batch}
