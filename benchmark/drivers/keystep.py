"""Closed-loop keystep driver: one robot, batch 1, the next keystep sent
when the last one's numpy output is back.

Entry: ``act3d_tpu_torch.eval.actioner.Actioner.predict`` (Act3D at eval,
then ``compute_trajectory``).  Keystep k takes observation k mod P of a
pool of seeded host observations, the ghost points of every level and the
sampler's initial and per-step noise from set k mod S (drawn by the
benchmark, handed in through ``ghost_points_override`` / ``noise``), and
starts a new episode (``load_episode``) every E keysteps, the task taken
in a seeded order from a bank of seeded instructions.

The window runs whole keysteps until ``--seconds`` have passed;
``keystep_ms`` is its length over the keysteps completed.  With
``--trace 1`` a profiled stretch of ``trace_keysteps`` more keysteps
follows the window.  The Act3D adapter's ``recorder`` keeps each
keystep's Act3D choices (its output's ``position_pyramid``).  The check
reruns a seeded sample of the window's keysteps through the
reference, following those choices, and compares each action and
trajectory with the one the window produced.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time

import numpy as np
import torch

from .. import generators, harness, models, trace
from ..harness import Check, Outcome, derive

# the keystep's two models, each built by the configuration's adapter of that role
ROLES = ("act3d", "planner")


class Inputs:
    """The cell's traffic, drawn from the run's seed."""

    def __init__(self, cfg, tr, seed, device):
        a, p = cfg["act3d"], cfg["planner"]
        gen = torch.Generator(device=device).manual_seed(derive(seed, "traffic"))
        levels = a["num_sampling_level"]
        self.pool = generators.observation_pool(tr["observation_pool"], cfg["ncam"],
                                                cfg["image_size"], cfg["workspace_bounds"],
                                                gen, device)
        self.bank = generators.instruction_bank(tr["instruction_bank"], gen, device)
        diameters = [None] + [a["fine_sampling_ball_diameter"] / d for d in (1.0, 4.0, 16.0)]
        self.ghosts = generators.ghost_sets(tr["input_sets"],
                                            [a["num_ghost_points_val"] // levels] * levels,
                                            diameters[:levels], cfg["workspace_bounds"], gen,
                                            device)
        self.noises = generators.noise_sets(tr["input_sets"], p["diffusion_timesteps"],
                                            p["trajectory_length"],
                                            models.adapter(cfg, "planner").noise_width(cfg),
                                            gen, device)
        self.tasks = [f"task{i}" for i in np.random.default_rng(
            derive(seed, "episodes")).permutation(len(self.bank))]
        self.episode = tr["episode_keysteps"]
        self.mask = np.zeros((1, p["trajectory_length"]), bool)

    def instructions(self):
        return {f"task{i}": {0: [self.bank[i]]} for i in range(len(self.bank))}

    def task(self, k):
        return self.tasks[(k // self.episode) % len(self.tasks)]

    def of(self, k):
        """(observation, instruction, ghost points, noise) of keystep k."""
        return (self.pool[k % len(self.pool)], self.bank[int(self.task(k)[4:])],
                self.ghosts[k % len(self.ghosts)], self.noises[k % len(self.noises)])


def reference_keystep(ref_act3d, ref_planner, inputs: Inputs, k: int, follow=None):
    """The reference's output for keystep k in the system's layout (action
    (1, 8), trajectory (1, L, 7)), its Act3D choices (each level's (1, 3)
    position) and the choice gap.

    Act3D's argmax over ghost points is a discrete choice that rounding
    swings where scores lie close: with random weights a fine level's
    scores lie within a few 1e-5 of each other.  As a served model's tokens
    are judged, the reference follows the system's choices (``follow``, each
    level's position) and judges each by how far its score lies below the
    reference's best, over the scale of a score's rounding (|query| times
    the largest |ghost feature|: the choice gap).  Without ``follow`` the
    reference takes its own argmax at every level."""
    dev = ref_act3d.gripper_loc_bounds.device
    (rgb, pcd, grip), instr, ghosts, (init, steps) = inputs.of(k)
    rgb = torch.as_tensor(rgb, device=dev) / 2 + 0.5
    pcd = torch.as_tensor(pcd, device=dev)
    grip = torch.as_tensor(grip, device=dev)
    instr = torch.as_tensor(instr[None], device=dev)
    with torch.no_grad():
        pred = ref_act3d(rgb, pcd, instr, grip, ghost_points=ghosts, follow=follow)
    action = torch.cat([pred["position"], pred["rotation"], pred["gripper"]], dim=1)
    traj = ref_planner.sample(torch.as_tensor(inputs.mask, device=dev), rgb, pcd, instr,
                              grip[:, :7], action[:, :7], init, steps)
    out = {"action": action.cpu().numpy(), "trajectory": traj.cpu().numpy()}
    return out, pred["position_pyramid"], float(pred["choice_gap"])


def references(cfg, seed, device):
    """Both reference models at eval, without gradients."""
    return tuple(models.adapter(cfg, role).reference(cfg, derive(seed, f"weights.{role}"),
                                                     device).eval().requires_grad_(False)
                 for role in ROLES)


def check(cfg, seed, device, inputs: Inputs, produced: dict):
    """Each sampled keystep's outputs (``produced``: k -> (outputs, Act3D
    choices)) against the reference's: the widest choice gap and the
    largest absolute gaps of the action and the trajectory."""
    ref_a, ref_p = references(cfg, seed, device)
    gaps = {"choice_gap": 0.0, "action_gap": 0.0, "trajectory_gap": 0.0}
    with harness.float32("ieee"):
        for k, (out, chosen) in sorted(produced.items()):
            ref, _, choice = reference_keystep(ref_a, ref_p, inputs, k, chosen)
            gaps["choice_gap"] = max(gaps["choice_gap"], choice)
            gaps["action_gap"] = max(gaps["action_gap"], harness.gap(out["action"], ref["action"]))
            gaps["trajectory_gap"] = max(gaps["trajectory_gap"],
                                         harness.gap(out["trajectory"], ref["trajectory"]))
    return gaps, (ref_a, ref_p)


def run(ctx) -> Outcome:
    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    cuda = dev == "cuda"
    from act3d_tpu_torch.eval.actioner import Actioner

    inputs = Inputs(cfg, tr, seed, dev)
    act3d, planner = (models.program(role, cfg, derive(seed, f"weights.{role}"), dev)
                      for role in ROLES)
    actioner = Actioner(act3d, planner, instructions=inputs.instructions(),
                        seed=derive(seed, "actioner"), device=dev)

    def keystep(k, timed=False):
        if k % inputs.episode == 0:
            actioner.load_episode(inputs.task(k), 0)
        (rgb, pcd, grip), _, ghosts, noise = inputs.of(k)
        return actioner.predict(rgb, pcd, grip, trajectory_mask=inputs.mask, timed=timed,
                                ghost_points_override=ghosts, noise=noise)

    # each keystep's Act3D choices, for the reference to follow
    recording = contextlib.ExitStack()
    chosen = recording.enter_context(models.adapter(cfg, "act3d").recorder(act3d))
    for k in range(tr["warmup_keysteps"]):
        keystep(k)
    chosen.clear()
    start = time.perf_counter()
    setup_s = start - ctx.t0
    outputs, phases, ends = [], [], []
    k = 0
    while True:
        outputs.append(keystep(k))
        ends.append(time.perf_counter())
        k += 1
        if time.perf_counter() - start >= ctx.seconds:
            break
    elapsed = time.perf_counter() - start
    window_keysteps = k
    per = np.diff([start] + ends) * 1e3
    print(f"window: {k} keysteps in {elapsed:.3f} s; set-up {setup_s:.2f} s; keystep ms "
          + " ".join(f"{x:.0f}" for x in per), file=sys.stderr)
    session = None
    if ctx.trace:  # the traced stretch follows the window, which the profiler never slowed
        session = trace.Session()
        session.start()
        for _ in range(tr["trace_keysteps"]):
            outputs.append(keystep(k, timed=True))
            phases.append(actioner.last_phase_seconds)
            k += 1
        session.stop()

    failed = sum(not (np.isfinite(o["action"]).all() and np.isfinite(o["trajectory"]).all())
                 for o in outputs)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    recording.close()
    del actioner, act3d, planner
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    layer = {}
    traced = None
    if session is not None:
        traced = session.read()
        layer.update(keysteps_traced=len(phases),
                     act3d_s=float(np.mean([p["act3d"] for p in phases])),
                     sampler_s=float(np.mean([p["sampler"] for p in phases])),
                     untraced_keystep_s=elapsed / window_keysteps)

    rng = np.random.default_rng(derive(seed, "check"))
    sample = rng.choice(k, size=min(tr["check_keysteps"], k), replace=False)
    gaps, refs = check(cfg, seed, dev, inputs,
                       {int(i): (outputs[i], chosen[i]) for i in sample})
    if session is not None:
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as counter, harness.float32("ieee"):
            reference_keystep(*refs, inputs, int(sample[0]))
        layer["flops_per_keystep"] = float(counter.get_total_flops())
    limits = tr["limits"]
    return Outcome(
        attempted=k, failed=int(failed),
        end_to_end={"keystep_ms": elapsed / window_keysteps * 1e3, "peak_mem_mib": peak / 2**20,
                    "setup_s": setup_s},
        checks=[Check(name, gaps[name], limits[name]) for name in gaps],
        memory_peak_bytes=peak, layer=layer, traced=traced)


def control(ctx, mode: str = "tf32") -> dict:
    """The control: the reference in the system's place over the first
    ``check_keysteps`` keysteps, in ``mode`` (TF32: the precision below the
    configuration's float32), judged by the same comparison.  Returns the
    readings."""
    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    inputs = Inputs(cfg, tr, seed, dev)
    ref_a, ref_p = references(cfg, seed, dev)
    with harness.float32(mode):
        produced = {k: reference_keystep(ref_a, ref_p, inputs, k)[:2]
                    for k in range(tr["check_keysteps"])}
    del ref_a, ref_p
    return check(cfg, seed, dev, inputs, produced)[0]
