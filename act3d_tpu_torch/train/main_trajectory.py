"""Trajectory-diffusion training entry point (PyTorch).

The port of ``act3d_tpu/train/main_trajectory.py``, the reference
``main_trajectory.py``: packaged episodes -> ``RLBenchDataset`` (dense
trajectories) -> ``DeviceFeeder`` -> ``Trainer.step`` (DiffusionPlanner's
denoising loss, AdamW).  Every ``val_freq`` steps: the eval-mode loss
averaged over the reference's number of batches on the train and the val
set, then the sampler eval (the full reverse diffusion of
``compute_trajectory`` on one val batch, scored by
``TrajectoryCriterion``), a log line, and best/last checkpoints keyed on
``traj_action_mse``.  SIGTERM/SIGINT checkpointing and ``--eval_only`` as
in JAX.  The host path takes JAX's flags (``--num_workers``,
``--device_augment``, ``--compact_transfer``, ``--wire depth``,
``--instr_mode ids``); with ``--use_tensorboard 1`` the scalars go to a
TensorBoard event file too, with the sampler eval's scatter image of its
first sample (``val-viz/viz``).  It runs on the card unless ``--device
cpu`` is given.  Under ``torchrun --nproc_per_node N``
``--num_devices N`` / ``--fsdp F`` train one global batch over the N
ranks (DDP, or FSDP2 on the (N/F, F) mesh; ``train/cli.py``,
``parallel/mesh.py``).

Run:
  python -m act3d_tpu_torch.train.main_trajectory \\
      --dataset /path/train --valset /path/val --tasks pick_and_lift \\
      --instructions instructions.pkl --dense_interpolation 1 \\
      --interpolation_length 50 --use_goal 1 --use_instruction 1

As in ``main_keypose``, no example batch is drawn to initialise the model,
and the loss is read only at each evaluation.
"""

from __future__ import annotations

import torch

from ..core.config import TrajectoryConfig, parse_config
from ..data.dataset import RLBenchDataset
from ..data.feeder import to_tensors
from ..device import resolve_device
from ..models import DiffusionPlanner, compute_trajectory
from ..parallel.collectives import mean_over_ranks
from ..parallel.mesh import shutdown_distributed
from ..utils.registry import count_parameters
from .cli import (WIRE_KEYS, best_metric, compact_wire, dataset_args, device_augment,
                  host_batch, load_cli_instructions, n_eval_batches, parallel_setup,
                  run_training, train_dataset_args, train_sampler, workspace_bounds)
from .engine import Trainer, resume, summary_writer_class
from .flagship import (canonical_batch, diffusion_loss_fn, diffusion_metrics_fn,
                       instruction_bank_on)
from .losses import TrajectoryCriterion

MODEL_KEYS = ("trajectory", "trajectory_mask", "rgbs", "pcds", "instr", "curr_gripper",
              "action") + WIRE_KEYS


def main(argv=None):
    cfg = parse_config(TrajectoryConfig, argv)
    dev = resolve_device(cfg.device)
    mesh, rank, world = parallel_setup(cfg, dev)
    if cfg.use_tensorboard:
        summary_writer_class()
    bounds = workspace_bounds(cfg)
    if rank == 0:
        cfg.save(cfg.log_dir / "hparams.json")
    instruction = load_cli_instructions(cfg)
    common = dataset_args(cfg, instruction, bounds, rank, world, return_low_lvl_trajectory=True,
                          dense_interpolation=bool(cfg.dense_interpolation),
                          interpolation_length=cfg.interpolation_length,
                          action_dim=cfg.action_dim)
    train_kwargs = train_dataset_args(cfg, common)
    train_ds = RLBenchDataset(**train_kwargs)
    val_ds = RLBenchDataset(root=cfg.valset, cache_size=cfg.cache_size_val, training=False,
                            **common)
    augment = device_augment(cfg, train_ds, bounds, ("curr_gripper", "action", "trajectory"))

    torch.manual_seed(cfg.seed)
    model = DiffusionPlanner(
        backbone=cfg.backbone,
        image_size=cfg.image_size_tuple,
        embedding_dim=cfg.embedding_dim,
        output_dim=cfg.action_dim,
        num_vis_ins_attn_layers=cfg.num_vis_ins_attn_layers,
        num_query_cross_attn_layers=cfg.num_query_cross_attn_layers,
        use_instruction=bool(cfg.use_instruction),
        use_goal=bool(cfg.use_goal),
        use_goal_at_test=bool(cfg.use_goal_at_test),
        feat_scales_to_use=cfg.feat_scales_to_use,
        attn_rounds=cfg.attn_rounds,
        rotation_parametrization=cfg.rotation_parametrization,
        diffusion_timesteps=cfg.diffusion_timesteps,
        gripper_loc_bounds=tuple(map(tuple, bounds)),
        device=dev,
    )
    if rank == 0:
        print("Model parameters:", count_parameters(model))
    bank = train_ds.instruction_bank
    compute_dtype = torch.bfloat16 if cfg.mixed_precision else None
    trainer = Trainer(diffusion_loss_fn(model, compute_dtype, augment=augment, instr_bank=bank),
                      model,
                      metrics_fn=diffusion_metrics_fn(model, instr_bank=bank), lr=cfg.lr,
                      accumulate_grad_batches=cfg.accumulate_grad_batches,
                      log_dir=cfg.log_dir, seed=cfg.seed,
                      use_tensorboard=bool(cfg.use_tensorboard), mesh=mesh,
                      compute_dtype=compute_dtype)
    resume(trainer, cfg.log_dir, cfg.checkpoint, bool(cfg.auto_resume))
    sampler_bank = instruction_bank_on(bank, dev)

    def batches(dataset, batch_size):
        return [to_tensors(host_batch(dataset, batch_size, MODEL_KEYS), dev)
                for _ in range(n_eval_batches(cfg))]

    def run_sampler_eval(step_id):
        """The reference's run_inference path (main_trajectory.py:218-259):
        100-step reverse diffusion on one val batch (its wire decoded first;
        each rank its rows, the noise drawn at the global batch) and its
        trajectory metrics averaged over the ranks (per-sample entries left
        out); with TensorBoard, the first sample's scatter image."""
        vb = canonical_batch(to_tensors(host_batch(val_ds, cfg.batch_size_val, MODEL_KEYS),
                                        dev), sampler_bank)
        trainer.runner.eval()  # through the wrapper: FSDP2 gathers the root's params
        pred = trainer.runner(compute_trajectory, model, vb["trajectory_mask"], vb["rgbs"],
                              vb["pcds"], vb["instr"], vb["curr_gripper"], vb["action"],
                              generator=trainer.generators)
        metrics = TrajectoryCriterion.compute_metrics(pred, vb["trajectory"])
        if trainer.logger and trainer.logger.tb is not None:
            from .viz import trajectory_scatter_image

            img = trajectory_scatter_image(
                pred[0].cpu().numpy(), vb["trajectory"][0].cpu().numpy(),
                vb["trajectory_mask"][0].cpu().numpy())
            trainer.logger.tb.add_image("val-viz/viz", img, step_id)
        return {k: mean_over_ranks(float(v.mean())) for k, v in metrics.items()
                if not k.startswith("per_sample/")}

    def evaluate(step_id):
        train_metrics = trainer.evaluate(batches(train_ds, cfg.batch_size))
        val_metrics = trainer.evaluate(batches(val_ds, cfg.batch_size_val))
        val_metrics.update(run_sampler_eval(step_id))
        return train_metrics, val_metrics

    try:
        if cfg.eval_only:
            metrics = trainer.evaluate(batches(val_ds, cfg.batch_size_val))
            for k, v in sorted(metrics.items()):
                if rank == 0:
                    print(f"{k}: {v:.4f}")
            return metrics
        compact = compact_wire(cfg, train_ds)
        sampler = train_sampler(cfg, train_kwargs, compact)
        evals = run_training(
            cfg, trainer,
            lambda: host_batch(train_ds, cfg.batch_size, MODEL_KEYS, sampler, compact),
            dev, evaluate, "train-loss/noise_mse", best_metric(cfg, "traj_action_mse"),
            sampler)
        return {"evals": evals}
    finally:
        if trainer.logger:
            trainer.logger.close()
        shutdown_distributed()


if __name__ == "__main__":
    main()
