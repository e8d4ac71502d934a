"""Act3D keypose training entry point (PyTorch).

The port of ``act3d_tpu/train/main_keypose.py``, the reference
``main_keypose.py``: packaged episodes -> ``RLBenchDataset`` ->
``DeviceFeeder`` -> ``Trainer.step`` (Act3D, ``KeyposeLossAndMetrics``,
AdamW), with the aggregated evaluation on the train and val sets every
``val_freq`` steps, best/last checkpoints keyed on ``mean/pos_l2_final``,
SIGTERM/SIGINT checkpointing and ``--eval_only``.  The host path takes
JAX's flags: ``--num_workers`` (worker processes, ``data/pipeline.py``),
``--device_augment`` (Resize / Rotate on the card), ``--compact_transfer``,
``--wire depth``, ``--instr_mode ids`` and ``--use_tensorboard``.  It runs
on the card unless ``--device cpu`` is given.  Under ``torchrun --nproc_per_node N``
``--num_devices N`` / ``--fsdp F`` train one global batch over the N
ranks (DDP, or FSDP2 on the (N/F, F) mesh; ``train/cli.py``,
``parallel/mesh.py``).

Run:
  python -m act3d_tpu_torch.train.main_keypose \\
      --dataset /path/train --valset /path/val --tasks pick_and_lift \\
      --instructions instructions.pkl --use_instruction 1

JAX draws one example batch from the training set to initialise the flax
parameters; the port builds its module without one, so its training
batches are JAX's shifted by one draw.  As in JAX, the loss is read only
at each evaluation.  ``main`` returns the evaluations (or, with
``--eval_only``, the metrics).
"""

from __future__ import annotations

import torch

from ..core.config import KeyposeConfig, parse_config
from ..data.dataset import RLBenchDataset
from ..data.feeder import to_tensors
from ..device import resolve_device
from ..models import Act3D
from ..parallel.collectives import synchronize_between_processes
from ..parallel.mesh import shutdown_distributed
from ..utils.registry import count_parameters
from .cli import (WIRE_KEYS, best_metric, compact_wire, dataset_args, device_augment,
                  host_batch, load_cli_instructions, n_eval_batches, parallel_setup,
                  run_training, train_dataset_args, train_sampler, workspace_bounds)
from .engine import Trainer, resume, summary_writer_class
from .flagship import keypose_loss_fn, keypose_metrics_fn
from .losses import KeyposeLossAndMetrics, split_metrics_by_task

MODEL_KEYS = ("rgbs", "pcds", "instr", "curr_gripper", "action") + WIRE_KEYS


def main(argv=None):
    cfg = parse_config(KeyposeConfig, argv)
    dev = resolve_device(cfg.device)
    mesh, rank, world = parallel_setup(cfg, dev)
    if cfg.use_tensorboard:
        summary_writer_class()
    bounds = workspace_bounds(cfg)
    if rank == 0:
        cfg.save(cfg.log_dir / "hparams.json")
    instruction = load_cli_instructions(cfg)
    common = dataset_args(cfg, instruction, bounds, rank, world, return_low_lvl_trajectory=False,
                          action_dim=8)
    train_kwargs = train_dataset_args(cfg, common)
    train_ds = RLBenchDataset(**train_kwargs)
    val_ds = RLBenchDataset(root=cfg.valset, cache_size=cfg.cache_size_val, training=False,
                            **common)
    augment = device_augment(cfg, train_ds, bounds, ("curr_gripper", "action"))

    torch.manual_seed(cfg.seed)
    model = Act3D(
        backbone=cfg.backbone,
        image_size=cfg.image_size_tuple,
        embedding_dim=cfg.embedding_dim,
        num_ghost_point_cross_attn_layers=cfg.num_ghost_point_cross_attn_layers,
        num_query_cross_attn_layers=cfg.num_query_cross_attn_layers,
        num_vis_ins_attn_layers=cfg.num_vis_ins_attn_layers,
        rotation_parametrization=cfg.rotation_parametrization,
        gripper_loc_bounds=tuple(map(tuple, bounds)),
        num_ghost_points=cfg.num_ghost_points,
        num_ghost_points_val=cfg.num_ghost_points_val,
        weight_tying=bool(cfg.weight_tying),
        gp_emb_tying=bool(cfg.gp_emb_tying),
        num_sampling_level=cfg.num_sampling_level,
        fine_sampling_ball_diameter=cfg.fine_sampling_ball_diameter,
        regress_position_offset=bool(cfg.regress_position_offset),
        use_instruction=bool(cfg.use_instruction),
        approx_topk=bool(cfg.approx_topk),
        device=dev,
    )
    if rank == 0:
        print("Model parameters:", count_parameters(model))
    criterion = KeyposeLossAndMetrics(
        position_loss=cfg.position_loss,
        rotation_parametrization=cfg.rotation_parametrization,
        compute_loss_at_all_layers=bool(cfg.compute_loss_at_all_layers),
        ground_truth_gaussian_spread=cfg.ground_truth_gaussian_spread,
        label_smoothing=cfg.label_smoothing,
        position_loss_coeff=cfg.position_loss_coeff,
        position_offset_loss_coeff=cfg.position_offset_loss_coeff,
        rotation_loss_coeff=cfg.rotation_loss_coeff,
        gripper_loss_coeff=cfg.gripper_loss_coeff,
        symmetric_rotation_loss=bool(cfg.symmetric_rotation_loss),
    )
    bank = train_ds.instruction_bank
    compute_dtype = torch.bfloat16 if cfg.mixed_precision else None
    trainer = Trainer(
        keypose_loss_fn(model, criterion, compute_dtype,
                        bool(cfg.use_ground_truth_position_for_sampling_train),
                        augment=augment, instr_bank=bank),
        model,
        metrics_fn=keypose_metrics_fn(model, criterion,
                                      bool(cfg.use_ground_truth_position_for_sampling_val),
                                      instr_bank=bank),
        lr=cfg.lr,
        accumulate_grad_batches=cfg.accumulate_grad_batches,
        log_dir=cfg.log_dir,
        seed=cfg.seed,
        use_tensorboard=bool(cfg.use_tensorboard),
        mesh=mesh,
        compute_dtype=compute_dtype,
    )
    resume(trainer, cfg.log_dir, cfg.checkpoint, bool(cfg.auto_resume))

    def run_eval(dataset):
        """Aggregated n-batch eval, metrics split by task and averaged over
        batches (reference engine.py:155-174); over several ranks the
        per-sample metrics and task names of the ranks' rows are gathered
        first, so each batch is split as the global batch."""
        sums, counts = {}, {}
        for _ in range(n_eval_batches(cfg)):
            vb = host_batch(dataset, cfg.batch_size_val, MODEL_KEYS + ("task",))
            tasks = vb.pop("task")
            metrics = trainer.eval_step(to_tensors(vb, dev))
            if world > 1:
                metrics = synchronize_between_processes(
                    {k: v.cpu().numpy() for k, v in metrics.items()} | {"task": tasks})
                tasks = list(metrics.pop("task"))
            for k, v in split_metrics_by_task(metrics, tasks).items():
                sums[k] = sums.get(k, 0.0) + v
                counts[k] = counts.get(k, 0) + 1
        return {k: sums[k] / counts[k] for k in sums}

    try:
        if cfg.eval_only:
            metrics = run_eval(val_ds)
            for k, v in sorted(metrics.items()):
                if rank == 0:
                    print(f"{k}: {v:.4f}")
            return metrics
        compact = compact_wire(cfg, train_ds)
        sampler = train_sampler(cfg, train_kwargs, compact)
        evals = run_training(
            cfg, trainer,
            lambda: host_batch(train_ds, cfg.batch_size, MODEL_KEYS, sampler, compact), dev,
            lambda step: (run_eval(train_ds), run_eval(val_ds)),
            "train-loss/total", best_metric(cfg, "mean/pos_l2_final"), sampler)
        return {"evals": evals}
    finally:
        if trainer.logger:
            trainer.logger.close()
        shutdown_distributed()


if __name__ == "__main__":
    main()
