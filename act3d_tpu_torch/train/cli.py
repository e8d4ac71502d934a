"""What the two training CLIs (``main_keypose``, ``main_trajectory``)
share: workspace bounds, dataset arguments, instructions, the reference's
evaluation size and best-checkpoint key, and the step loop with its
periodic evaluation and checkpoints."""

from __future__ import annotations

import time

import numpy as np

from ..data.feeder import DeviceFeeder
from ..utils.registry import get_gripper_loc_bounds, load_instructions
from .engine import GracefulShutdown, Trainer

__all__ = ["best_metric", "dataset_args", "host_batch", "load_cli_instructions",
           "n_eval_batches", "run_training", "workspace_bounds"]


def workspace_bounds(cfg) -> np.ndarray:
    """(2, 3) gripper workspace: the task's bounds (or the union) plus a
    4 cm buffer, or the ±2 m cube without a bounds file."""
    if cfg.gripper_loc_bounds is None:
        return np.array([[-2.0, -2.0, -2.0], [2.0, 2.0, 2.0]])
    return get_gripper_loc_bounds(cfg.gripper_loc_bounds,
                                  task=cfg.tasks[0] if len(cfg.tasks) == 1 else None,
                                  buffer=0.04)


def dataset_args(cfg, instruction, bounds, **extra):
    """RLBenchDataset arguments shared by the train and val sets."""
    return dict(
        instructions=instruction,
        taskvar=[(task, var) for task, var_instr in instruction.items() for var in var_instr],
        max_episodes_per_task=cfg.max_episodes_per_task,
        cameras=cfg.cameras,
        gripper_loc_bounds=bounds,
        image_rescale=cfg.image_rescale_tuple,
        point_cloud_rotate_yaw_range=cfg.point_cloud_rotate_yaw_range,
        seed=cfg.seed,
        **extra,
    )


def host_batch(dataset, batch_size: int, keys) -> dict:
    """``dataset.sample_batch(batch_size)`` cut to the model's ``keys``."""
    return {k: v for k, v in dataset.sample_batch(batch_size).items() if k in keys}


def load_cli_instructions(cfg):
    instruction = load_instructions(cfg.instructions, tasks=cfg.tasks,
                                    variations=cfg.variations)
    if instruction is None:
        raise NotImplementedError("instructions.pkl is required")
    return instruction


def n_eval_batches(cfg) -> int:
    """Reference protocol (engine.py:155-174): max(5, 4·tasks / batch_size_val)."""
    return max(5, 4 * max(len(cfg.tasks), 1) // cfg.batch_size_val)


def best_metric(cfg, default: str):
    """The val metric that keys best.pt (None: every save is best)."""
    key = default if cfg.best_checkpoint_metric == "default" else cfg.best_checkpoint_metric
    return key or None


def run_training(cfg, trainer: Trainer, batch_fn, device, evaluate, loss_key: str,
                 metric_key):
    """The CLIs' step loop, from ``trainer.step_count`` to ``train_iters``:
    ``trainer.step`` on each batch of ``batch_fn`` (a host batch, moved to
    ``device`` by a :class:`DeviceFeeder`); every ``val_freq`` steps the
    loss is read (the loop's only read of a device value), ``evaluate()`` ->
    (train metrics, val metrics), a log line and a best/last checkpoint; on
    SIGTERM/SIGINT a last checkpoint.  The log line also carries the mean
    wall time per step since the last evaluation and the mean wait in the
    feeder.  Returns the evaluations."""
    evals = []
    feeder = DeviceFeeder(batch_fn, device=device)
    try:
        with GracefulShutdown() as stop:
            period_start, n_steps, waited = time.perf_counter(), 0, 0.0
            for step_id in range(trainer.step_count, cfg.train_iters):
                if stop.requested:
                    print(f"Shutdown requested: checkpointing at step {step_id}")
                    trainer.save_checkpoint(cfg.log_dir, last_only=True)
                    break
                t0 = time.perf_counter()
                batch = next(feeder)
                waited += time.perf_counter() - t0
                out = trainer.step(batch)
                n_steps += 1
                if (step_id + 1) % cfg.val_freq:
                    continue
                loss = float(out["loss"])
                step_s = (time.perf_counter() - period_start) / n_steps
                data_wait_s = waited / n_steps
                t0 = time.perf_counter()
                train_metrics, val_metrics = evaluate()
                evals.append(dict(step=step_id, loss=loss, seconds=time.perf_counter() - t0,
                                  train=train_metrics, val=val_metrics))
                if trainer.logger:
                    trainer.logger.log(
                        step_id,
                        {loss_key: loss, "time/step_s": step_s, "time/data_wait_s": data_wait_s}
                        | {f"train-losses/{k}": v for k, v in train_metrics.items()}
                        | {f"val-losses/{k}": v for k, v in val_metrics.items()},
                    )
                # a missing key maps to None, which save_checkpoint treats as best
                trainer.save_checkpoint(
                    cfg.log_dir, new_loss=val_metrics.get(metric_key) if metric_key else None)
                print(f"Step {step_id}: loss {loss:.4f} val {val_metrics}")
                period_start, n_steps, waited = time.perf_counter(), 0, 0.0
    finally:
        feeder.close()
    return evals
