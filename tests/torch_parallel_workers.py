"""Rank functions of tests/test_torch_parallel.py and the launcher that runs
them in spawned processes over gloo (a FileStore rendezvous, no TCP port).

Each rank function takes (rank, world, *args) and returns picklable
results; called with (0, 1) in the test process and no process group, it
is the one-device run the ranks are held against.  Imports no JAX.
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn as nn

SPAWN_TIMEOUT_S = 240


def _entry(rank, world, store_path, fn, args, queue):
    try:
        torch.set_num_threads(2)
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
        try:
            queue.put((rank, fn(rank, world, *args), None))
        finally:
            dist.destroy_process_group()
    except BaseException:  # handed to the test
        queue.put((rank, None, traceback.format_exc()))


def _next_result(queue, procs, timeout):
    """The next rank's (rank, result, error) from ``queue``, waiting at most
    ``timeout`` seconds; a rank that died without putting one fails at
    once instead of at the timeout."""
    import queue as queue_module

    deadline = time.monotonic() + timeout
    while True:
        try:
            return queue.get(timeout=2)
        except queue_module.Empty:
            dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if dead or time.monotonic() > deadline:
                raise RuntimeError(f"ranks died (exit codes {dead}) or timed out") from None


def spawn(fn, world: int, tmp_path, *args):
    """``fn(rank, world, *args)`` in ``world`` spawned processes over one
    gloo group; the results in rank order.  A rank's exception is raised
    here with its traceback; every process is joined."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    # a fresh store file per launch: a used one holds the last group's keys
    store_path = tempfile.mktemp(prefix=f"store-{fn.__name__}-{world}-", dir=str(tmp_path))
    procs = [ctx.Process(target=_entry, args=(r, world, store_path, fn, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    out = []
    try:
        while len(out) < world:
            out.append(_next_result(queue, procs, SPAWN_TIMEOUT_S))
            if out[-1][2]:  # the other ranks may wait in a collective forever
                raise RuntimeError(f"rank {out[-1][0]} failed:\n{out[-1][2]}")
    finally:
        for p in procs:
            p.join(timeout=30 if len(out) == world else 1)
            if p.is_alive():
                p.kill()
                p.join()
    return [r for _, r, _ in sorted(out, key=lambda t: t[0])]


def _mesh(world, fsdp):
    from act3d_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(world, fsdp, "cpu")


def _full(t):
    from act3d_tpu_torch.parallel.mesh import _full as full

    return full(t).detach().clone()


def _mean(value):
    from act3d_tpu_torch.parallel.collectives import mean_over_ranks

    return mean_over_ranks(value)


# ------------------------------------------------------------------ toy MLP
class ToyMLP(nn.Module):
    """tests/test_sharding.py's model: tanh(x w1) w2."""

    def __init__(self, w1, w2):
        super().__init__()
        self.w1 = nn.Parameter(torch.as_tensor(w1).clone())
        self.w2 = nn.Parameter(torch.as_tensor(w2).clone())

    def forward(self, x):
        return torch.tanh(x @ self.w1) @ self.w2


def toy_run(rank, world, fsdp, params, batch, steps, ckpt_dir=None, accumulate=1):
    """Loss of each step, final params (full), and with ``fsdp`` the
    per-rank bytes of trainable params and AdamW moments; with
    ``ckpt_dir`` a checkpoint after two steps, a second Trainer that loads
    it, and both Trainers' next losses; ``accumulate`` micro-batches per
    optimizer step (the ranks' gradients synchronised on the last)."""
    from act3d_tpu_torch.parallel.mesh import batch_rows
    from act3d_tpu_torch.train.engine import Trainer

    def make(model):
        def loss_fn(b, _gens):
            return torch.mean((model(b["x"]) - b["y"]) ** 2), {}

        return Trainer(loss_fn, model, lr=1e-2, mesh=_mesh(world, fsdp),
                       accumulate_grad_batches=accumulate)

    model = ToyMLP(params["w1"], params["w2"])
    trainer = make(model)
    full = {k: torch.as_tensor(v) for k, v in batch.items()}
    micro = [batch_rows(rank, world, {k: v[i::accumulate] for k, v in full.items()})
             for i in range(accumulate)]
    local = micro[0]
    out = {"losses": []}
    for i in range(steps):
        out["losses"].append(_mean(float(trainer.step(micro[i % accumulate])["loss"])))
        if ckpt_dir is not None and i == 1:
            trainer.save_checkpoint(ckpt_dir, new_loss=1.0)
            break
    out["params"] = {k: _full(p).numpy() for k, p in model.named_parameters()}
    out["local_bytes"] = sum(_local(p).numel() * 4 for p in model.parameters())
    out["local_moment_bytes"] = sum(
        _local(v).numel() * 4 for s in trainer.optimizer.state.values()
        for k, v in s.items() if k in ("exp_avg", "exp_avg_sq"))
    out["param_types"] = sorted({type(p).__name__ for p in model.parameters()})
    if ckpt_dir is not None:
        first = trainer
        second = make(ToyMLP(params["w1"], params["w2"]))
        second.load_checkpoint(os.path.join(ckpt_dir, "last.pt"))
        out["resumed_step"] = second.step_count
        out["resumed_params_equal"] = all(
            torch.equal(_full(a), _full(b)) for a, b in
            zip(first.model.parameters(), second.model.parameters()))
        out["next_losses"] = [_mean(float(t.step(local)["loss"])) for t in (first, second)]
        out["files"] = sorted(os.listdir(ckpt_dir)) if rank == 0 else None
    return out


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


# ---------------------------------------------------------- the two models
def _model(kind, seed=0):
    from act3d_tpu_torch.train.flagship import make_diffusion_model, make_keypose_model

    torch.manual_seed(seed)
    if kind == "diffusion":
        return make_diffusion_model(image_size=(64, 64), embedding_dim=24,
                                    num_query_cross_attn_layers=2, diffusion_timesteps=5,
                                    device="cpu")
    return make_keypose_model(image_size=(128, 128), embedding_dim=24, num_ghost_points=48,
                              num_ghost_points_val=48, num_sampling_level=2, device="cpu")


def _loss_fn(kind, model, compute_dtype):
    from act3d_tpu_torch.train.flagship import diffusion_loss_fn, keypose_loss_fn
    from act3d_tpu_torch.train.losses import KeyposeLossAndMetrics

    if kind == "diffusion":
        return diffusion_loss_fn(model, compute_dtype)
    return keypose_loss_fn(model, KeyposeLossAndMetrics(), compute_dtype)


def model_run(rank, world, kind, fsdp, batch, steps, bf16=False):
    """Full gradients of one backward (then zeroed), then ``steps``
    Trainer steps: {"grads": {name: array}, "losses": [...]} with the
    losses averaged over the ranks (the global batch's).  ``batch``: numpy
    arrays of the global batch; dropout is on (training mode)."""
    from act3d_tpu_torch.parallel.mesh import batch_rows
    from act3d_tpu_torch.train.engine import Trainer

    dtype = torch.bfloat16 if bf16 else None
    model = _model(kind)
    trainer = Trainer(_loss_fn(kind, model, dtype), model, lr=1e-3, seed=3,
                      mesh=_mesh(world, fsdp), compute_dtype=dtype)
    local = batch_rows(rank, world, {k: torch.from_numpy(v) for k, v in batch.items()})
    trainer.runner.train()
    loss, _ = trainer.runner(trainer._loss_fn, local, trainer.generators)
    loss.backward()
    grads = {n: _full(p.grad).float().numpy() for n, p in model.named_parameters()
             if p.grad is not None}
    trainer.optimizer.zero_grad(set_to_none=True)
    losses = [_mean(loss.item())]
    for _ in range(steps):
        losses.append(_mean(float(trainer.step(local)["loss"])))
    return {"grads": grads, "losses": losses,
            "master_dtypes": sorted({str(_full(p).dtype) for p in model.parameters()})}


def dropout_masks(rank, world, seed, b, h, l, s, rate):
    """This rank's attention keep mask (rows rank x b ..) and elementwise
    dropout mask of a (b, 16) input."""
    from act3d_tpu_torch.kernels.attention import dropout_keep
    from act3d_tpu_torch.nn.dropout import Generators, dropout

    keep = dropout_keep(seed, b, h, l, s, rate, b0=rank * b)
    gens = Generators.from_seed(seed, "cpu", rank, world)
    elem = dropout(torch.ones(b, 16), rate, gens) != 0
    return keep.numpy(), elem.numpy()


def gather_metrics(rank, world):
    from act3d_tpu_torch.parallel.collectives import (all_gather_metrics, any_rank,
                                                      synchronize_between_processes)

    return {"gathered": all_gather_metrics({"rank": rank, "v": float(rank) * 1.5}),
            "synced": synchronize_between_processes({"x": np.arange(2) + 10 * rank}),
            "any": any_rank(rank == world - 1), "none": any_rank(False)}


def cli_run(rank, world, name, argvs):
    """``main(argv)`` of a training CLI for each argv in turn on this rank
    (the group is the caller's); the evaluations each returned."""
    from act3d_tpu_torch.train import main_keypose, main_trajectory

    main = {"keypose": main_keypose, "trajectory": main_trajectory}[name].main
    return [{"evals": [{"step": e["step"], "loss": e["loss"], "val": e["val"]}
                       for e in main(argv)["evals"]]} for argv in argvs]


def state_layout(path) -> Dict[str, tuple]:
    payload = torch.load(path, weights_only=True)
    model = {k: (tuple(v.shape), str(v.dtype), type(v).__name__)
             for k, v in payload["model"].items()}
    opt = payload["optimizer"]
    return {"keys": sorted(payload), "model": model, "count": opt["count"],
            "opt_ids": [g["params"] for g in opt["optimizer"]["param_groups"]],
            "opt_state": {i: sorted(s) for i, s in opt["optimizer"]["state"].items()}}
