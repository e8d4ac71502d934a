"""What the two training CLIs (``main_keypose``, ``main_trajectory``)
share: workspace bounds, dataset arguments, instructions, the host batch
(in-process or from worker processes, compact-encoded or not), the device
augmentation, the reference's evaluation size and best-checkpoint key, and
the step loop with its periodic evaluation and checkpoints."""

from __future__ import annotations

import time

import numpy as np

from ..data.compact import compact_batch
from ..data.feeder import DeviceFeeder
from ..utils.registry import get_gripper_loc_bounds, load_instructions
from .engine import GracefulShutdown, Trainer

__all__ = ["WIRE_KEYS", "best_metric", "compact_wire", "dataset_args", "device_augment",
           "host_batch", "load_cli_instructions", "n_eval_batches", "run_training",
           "train_dataset_args", "train_sampler", "workspace_bounds"]

# batch keys of the depth wire and of instruction ids, which the loss and
# metric functions decode (data/depthwire.py, train/flagship.py)
WIRE_KEYS = ("depth", "cam_intr", "cam_c2w", "aug_rows", "aug_cols", "instr_id")


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
        max_episode_length=cfg.max_episode_length,
        max_episodes_per_task=cfg.max_episodes_per_task,
        cameras=cfg.cameras,
        gripper_loc_bounds=bounds,
        image_rescale=cfg.image_rescale_tuple,
        point_cloud_rotate_yaw_range=cfg.point_cloud_rotate_yaw_range,
        seed=cfg.seed,
        wire=cfg.wire,
        instr_mode=cfg.instr_mode,
        **extra,
    )


def train_dataset_args(cfg, common) -> dict:
    """The training set's RLBenchDataset arguments: with --device_augment
    the host only decodes and stacks, and Resize / Rotate run on the card."""
    return dict(root=cfg.dataset, cache_size=cfg.cache_size, training=True,
                num_iters=cfg.train_iters, augment_host=not cfg.device_augment, **common)


def host_batch(dataset, batch_size: int, keys, sampler=None, compact: bool = False) -> dict:
    """The next host batch cut to the model's ``keys``: ``next(sampler)``
    when there is one, else ``dataset.sample_batch(batch_size)``; with
    ``compact``, u8 rgbs / u16 pcds and depth (``compact_batch``, which
    leaves a batch the sampler's workers encoded as it is)."""
    batch = next(sampler) if sampler is not None else dataset.sample_batch(batch_size)
    batch = {k: v for k, v in batch.items() if k in keys}
    return compact_batch(batch) if compact else batch


def compact_wire(cfg, train_ds) -> bool:
    """Whether training batches ship compact: --compact_transfer, or the
    depth wire (f32 depth would waste its wire), as JAX's CLIs."""
    return bool(cfg.compact_transfer) or train_ds.wire == "depth"


def train_sampler(cfg, train_kwargs, compact: bool):
    """With --num_workers > 1, a MultiProcessSampler of training batches
    (worker w from 0 draws at seed ``cfg.seed + 1000 (w + 2)``, as JAX's
    workers; with ``compact`` the workers encode them) handing out zero-copy
    views, which the DeviceFeeder copies out before it asks for the next;
    else None (batches drawn in the feeder thread)."""
    if cfg.num_workers <= 1:
        return None
    from ..data.pipeline import MultiProcessSampler, rlbench_dataset_factory

    return MultiProcessSampler(rlbench_dataset_factory(train_kwargs, cfg.seed, compact),
                               batch_size=cfg.batch_size, num_workers=cfg.num_workers,
                               copy=False)


def device_augment(cfg, train_ds, bounds, pose_keys):
    """The loss functions' ``augment`` under --device_augment (else None).
    The depth wire draws its Resize on the host and ships it as index maps,
    so the two do not compose: ValueError, as in JAX."""
    if not cfg.device_augment:
        return None
    if train_ds.wire == "depth":
        raise ValueError("--device_augment does not compose with --wire depth: the depth "
                         "wire's resize index maps ARE the (host-drawn, device-executed) "
                         "augmentation")
    from ..data.device_augment import make_device_augment

    return make_device_augment(image_rescale=cfg.image_rescale_tuple,
                               yaw_range_deg=cfg.point_cloud_rotate_yaw_range,
                               gripper_loc_bounds=bounds, pose_keys=pose_keys)


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
                 metric_key, sampler=None):
    """The CLIs' step loop, from ``trainer.step_count`` to ``train_iters``:
    ``trainer.step`` on each batch of ``batch_fn`` (a host batch, moved to
    ``device`` by a :class:`DeviceFeeder`); every ``val_freq`` steps the
    loss is read (the loop's only read of a device value),
    ``evaluate(step)`` -> (train metrics, val metrics), a log line and a
    best/last checkpoint; on SIGTERM/SIGINT a last checkpoint.  The log
    line also carries the mean wall time per step since the last evaluation
    and the mean wait in the feeder.  ``sampler`` (the one ``batch_fn``
    draws from, if any) is closed after the feeder.  Returns the
    evaluations."""
    evals = []
    feeder = None
    try:
        feeder = DeviceFeeder(batch_fn, device=device)
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
                train_metrics, val_metrics = evaluate(step_id)
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
        if feeder is not None:
            feeder.close()
        if sampler is not None:
            sampler.close()
    return evals
