"""Training-step driver: ``Trainer.step`` of the configuration's training
model (its role ``train_model``: the adapter's loss, such as
``flagship.keypose_loss_fn`` for Act3D with ground-truth-centred fine
sampling, ``flagship.diffusion_loss_fn`` for the ChainedDiffuser),
float32 as the entry points ship, at the traffic file's batch.

Set-up makes a pool of distinct seeded batches on the device, warms every
shape of the step on a Trainer that is then thrown away, and builds the
Trainer the window drives from the same seed.  The window cycles the pool
with no per-step sync (losses stay on the device) and closes at a
``synchronize``; ``train_samples_per_s`` is batch x steps over its length.
With ``--trace 1`` a profiled stretch of ``trace_steps`` more steps follows
the window.
The window's first ``check_steps`` steps (on rows that all differ) are the
ones the check follows in the reference: it compares each step's loss, the
first gradient as AdamW got it (its first moment after one step over
1 - beta1), read inside the window after the first step, and the
parameters' change over those steps, read inside the window after the
last of them, leaf by leaf, and judges every choice of the system (the
adapter's ``recorder``, one entry a forward) it followed.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time

import numpy as np
import torch

from .. import harness, models, trace
from ..harness import Check, Outcome, derive
from ..reference.layers import Generators
from ..reference.optim import AdamW

BETA1 = 0.9


def make_batches(cfg, tr, seed, device):
    gen = torch.Generator(device=device).manual_seed(derive(seed, "traffic"))
    return models.adapter(cfg, cfg["train_model"]).batches(cfg, tr, gen, device)


def reference_steps(cfg, seed, batches, steps, device, mode="ieee", follow=None):
    """The reference's first ``steps`` steps: losses, the first gradient's
    norm per leaf, the parameters' change per leaf, the widest choice gap
    over the steps, and the reference's choices of each step (following
    ``follow``'s)."""
    kind = cfg["train_model"]
    adapter = models.adapter(cfg, kind)
    with harness.float32(mode):
        model = adapter.reference(cfg, derive(seed, f"weights.{kind}"), device).train()
        opt = AdamW(model, cfg["optimizer"]["lr"], cfg["optimizer"]["weight_decay"])
        before = {n: p.detach().clone() for n, p in opt.params.items()}
        gens = Generators.from_seed(derive(seed, "trainer"), device)
        losses, grad, choice, chosen = [], None, 0.0, []
        for i in range(steps):
            loss, choices, gap = adapter.reference_loss(model, batches[i], gens,
                                                        None if follow is None else follow[i])
            loss.backward()
            losses.append(float(loss.detach()))
            chosen.append(choices)
            choice = max(choice, gap)
            applied = opt.step()
            if grad is None:
                grad = {n: float(g.norm()) for n, g in applied.items()}
        change = {n: float((p.detach() - before[n]).norm()) for n, p in opt.params.items()}
    return (losses, grad, change, choice), chosen, model


def compare(readings, ref) -> dict:
    """The numbers a side's readings (losses, first gradient, change) give
    against the reference's, and the reference's widest choice gap on the
    side's choices (0 without them); a cell's traffic file names
    those it compares, each with its limit.

    Each leaf is read at its norm, the worst leaf's gap over the larger of
    its own reference norm and the median leaf's (``grad_gap``,
    ``change_gap``) or the median leaf's gap (``*_median``).  After AdamW's
    first step every element has moved by lr in the sign of its gradient,
    so elements whose gradient is rounding noise move by lr in a direction
    rounding set, and the later steps start from weights that differ by
    that much: the first step's loss (``loss_gap``) is steady where the
    later ones (``loss_gap_all_steps``) are not.  Leaves whose reference
    gradient is below a thousandth of the median leaf's are left out of the
    change: AdamW moves them by their rounding noise alone."""
    (losses, grad, change), (r_losses, r_grad, r_change, choice) = readings, ref
    med = float(np.median(list(r_grad.values())))
    moved = {n for n, g in r_grad.items() if g >= 1e-3 * med}
    return {"choice_gap": choice,
            "loss_gap": abs(losses[0] - r_losses[0]) / abs(r_losses[0]),
            "loss_gap_all_steps": max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
            "grad_gap": harness.leaf_gap(grad, r_grad),
            "grad_gap_median": _median_leaf_gap(grad, r_grad, set(r_grad)),
            "change_gap": harness.leaf_gap(change, r_change, keep=moved),
            "change_gap_median": _median_leaf_gap(change, r_change, moved)}


def _median_leaf_gap(prog, ref, keep) -> float:
    """The median over the kept leaves of |norm_prog - norm_ref| / norm_ref."""
    return float(np.median([abs(prog[n] - ref[n]) / ref[n] for n in ref
                            if n in keep and ref[n] > 0]))


def trainer_for(kind, cfg, seed, dev):
    """The system's model and a Trainer of it, built from the seed."""
    from act3d_tpu_torch.train.engine import Trainer

    adapter = models.adapter(cfg, kind)
    model = adapter.program(cfg, derive(seed, f"weights.{kind}"), dev)
    return model, Trainer(adapter.loss_fn(model), model, lr=cfg["optimizer"]["lr"],
                          weight_decay=cfg["optimizer"]["weight_decay"],
                          seed=derive(seed, "trainer"))


def run(ctx) -> Outcome:
    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    cuda = dev == "cuda"
    kind = cfg["train_model"]
    adapter = models.adapter(cfg, kind)
    batches = make_batches(cfg, tr, seed, dev)
    pool, checked = len(batches), tr["check_steps"]
    # every shape of the step warmed on a Trainer of its own, freed before
    # the window's Trainer is built, so the window's first steps are its first
    model, trainer = trainer_for(kind, cfg, seed, dev)
    for i in range(tr["warmup_steps"]):
        trainer.step(batches[i % pool])
    del model, trainer
    gc.collect()
    model, trainer = trainer_for(kind, cfg, seed, dev)
    names, params = zip(*[(n, p) for n, p in model.named_parameters() if p.requires_grad])
    before = [p.detach().clone() for p in params]
    # the checked steps' choices, for the reference to follow
    recording = contextlib.ExitStack()
    follow = recording.enter_context(adapter.recorder(model))

    steps, losses, grad, change = 0, [], None, None
    start = time.perf_counter()
    setup_s = start - ctx.t0
    while True:
        losses.append(trainer.step(batches[steps % pool])["loss"])
        steps += 1
        if steps == 1:
            state = trainer.optimizer.state
            grad = torch._foreach_norm([state[p]["exp_avg"] if "exp_avg" in state[p]
                                        else torch.zeros_like(p) for p in params])
        if steps == checked:
            change = torch._foreach_norm(torch._foreach_sub([p.detach() for p in params],
                                                            before))
            del before
            recording.close()
        if time.perf_counter() - start >= ctx.seconds and steps >= checked:
            break
    if cuda:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    window_steps = steps
    print(f"window: {steps} steps in {elapsed:.3f} s ({elapsed / steps * 1e3:.1f} ms a step); "
          f"set-up {setup_s:.2f} s", file=sys.stderr)
    session = None
    if ctx.trace:  # the traced stretch follows the window, which the profiler never slowed
        session = trace.Session()
        session.start()
        for _ in range(tr["trace_steps"]):
            losses.append(trainer.step(batches[steps % pool])["loss"])
            steps += 1
        session.stop()

    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    readings = ([float(x) for x in losses[:checked]],
                {n: float(g) / (1.0 - BETA1) for n, g in zip(names, grad)},
                {n: float(c) for n, c in zip(names, change)})
    del trainer, model, params, losses, grad, change
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    layer = {}
    traced = None
    if session is not None:
        traced = session.read()
        layer["steps_traced"] = tr["trace_steps"]
        layer["untraced_step_s"] = elapsed / window_steps

    ref_readings, _, ref = reference_steps(cfg, seed, batches, checked, dev,
                                           follow=follow or None)
    gaps = compare(readings, ref_readings)
    layer["readings"] = gaps
    if session is not None:
        from torch.utils.flop_counter import FlopCounterMode

        gens = Generators.from_seed(derive(seed, "trainer"), dev)
        with FlopCounterMode(display=False) as counter, harness.float32("ieee"):
            adapter.reference_loss(ref, batches[0], gens)[0].backward()
        layer["flops_per_step"] = float(counter.get_total_flops())
    limits = tr["limits"]
    return Outcome(
        attempted=steps, failed=failed,
        end_to_end={"train_samples_per_s": tr["batch"] * window_steps / elapsed,
                    "peak_mem_mib": peak / 2**20, "setup_s": setup_s},
        checks=[Check(name, gaps[name], limits[name]) for name in limits],
        memory_peak_bytes=peak, layer=layer, traced=traced)


def control(ctx, mode: str = "tf32") -> dict:
    """The control: the reference in the system's place, its first steps in
    ``mode`` (TF32: the precision below the configuration's float32),
    compared as the system is.  Returns the gaps."""
    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    batches = make_batches(cfg, tr, seed, dev)
    (losses, grad, change, _), chosen, model = reference_steps(
        cfg, seed, batches, tr["check_steps"], dev, mode)
    del model
    gc.collect()
    ref_readings, _, _ = reference_steps(cfg, seed, batches, tr["check_steps"], dev,
                                         follow=chosen)
    return compare((losses, grad, change), ref_readings)
