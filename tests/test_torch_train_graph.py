"""The training step replayed from CUDA graphs (``train/step_graph.py``,
``Trainer.step``) and the fused-MHA kernels' seed slots.

On the CPU: a :class:`SeedTape` draws k seeds as k attention calls draw
them one by one; the batch key changes with a tensor's pointer, shape,
strides and dtype; a key is sighted again within the last SEEN keys;
the plain attention versions drop with a seed slot's
seed as with the int; the slot launches pass the entries the slot's
pointer (fake library functions); the accumulator zeroes the
gradients in place; a Trainer on the CPU runs every step eagerly and
counts it so.

On the card (``-m gpu``; skipped without one), at tiny widths of the
one-block and the 3-scale x 2-round head (dropout 0.1): the host seeds,
timesteps, noise and dropout masks of steps run eager, capture, replay,
... are bitwise those of the same steps run eagerly; one step from one
state gives the eager loss bitwise and gradients within the spread of
eager runs, also at the benchmark training cells' widths (batch 22,
256^2, length 50; 19 and 114 dropout calls); a batch captured at its
second sighting; hooks, accumulation, a fifth batch, ``load_checkpoint`` and a
failed capture; the counters.  Launches over a seed slot equal launches
with the seed argument bitwise at the ChainedDiffuser sites, float32 and
bf16.  Nothing here imports JAX:

    python -m pytest --noconftest tests/test_torch_train_graph.py -m gpu
"""

import contextlib
import copy
import types

import pytest
import torch

from act3d_tpu_torch.kernels import attention
from act3d_tpu_torch.kernels.attention import (
    dropout_bits,
    fused_mha_backward,
    fused_mha_forward,
    fwd_plan_bf16,
)
from act3d_tpu_torch.models import DiffusionPlanner
from act3d_tpu_torch.ops.attention import SEED_HIGH, SeedTape
from act3d_tpu_torch.train.engine import Trainer
from act3d_tpu_torch.train.flagship import diffusion_loss_fn
from act3d_tpu_torch.train.optim import GradientAccumulator
from act3d_tpu_torch.train.step_graph import ENTRIES, SEEN, TrainStepGraphs, batch_key
from act3d_tpu_torch.utils import graphs
from act3d_tpu_torch.utils.testing import BOUNDS, synthetic_trajectory_batch

NCAM, IMAGE, N_INSTR, LENGTH, BATCH = 1, 64, 7, 8, 2
CFG = dict(image_size=(IMAGE, IMAGE), embedding_dim=24, output_dim=7,
           num_query_cross_attn_layers=3, num_vis_ins_attn_layers=1, use_instruction=True,
           use_goal=True, use_goal_at_test=False, diffusion_timesteps=10,
           gripper_loc_bounds=BOUNDS)
HEADS = {"1x1": {}, "3x2": dict(feat_scales_to_use=3, attn_rounds=2)}
# the benchmark's two training cells at their widths: the ChainedDiffuser
# of scripts/train_trajectory.sh at batch 22, one block or 3 x 2, and the
# dropout calls a step makes
CELLS = {"train_b22": (HEADS["1x1"], 19), "ms_train_b22": (HEADS["3x2"], 114)}
CELL_CFG = dict(backbone="clip", image_size=(256, 256), embedding_dim=120, output_dim=7,
                num_vis_ins_attn_layers=2, num_query_cross_attn_layers=6,
                use_instruction=True, use_goal=True, use_goal_at_test=False,
                rotation_parametrization="6D", diffusion_timesteps=100,
                gripper_loc_bounds=((-0.943886, -0.564358, 0.710619),
                                    (0.703883, 0.582063, 1.512219)))
gpu = pytest.mark.gpu


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the ops are tiny and the suite runs beside other
    test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, device="cpu"):
    batch = synthetic_trajectory_batch(BATCH, NCAM, (IMAGE, IMAGE), LENGTH, seed=seed)
    batch["instr"] = batch["instr"][:, :N_INSTR].contiguous()
    return {k: v.to(device) for k, v in batch.items()}


def _trainer(head, device, seed=5, **kwargs):
    torch.manual_seed(0)
    model = DiffusionPlanner(**CFG, **HEADS[head], device=device)
    return Trainer(diffusion_loss_fn(model), model, lr=1e-3, seed=seed, **kwargs)


def _counts():
    return (Trainer.eager_steps, Trainer.replayed_steps, Trainer.captures)


# ------------------------------------------------------------------ CPU
@pytest.mark.parametrize("k", [1, 19, 114])
def test_seed_tape_draws_equal_per_call_draws(k):
    """k draws of the tape equal k per-call int31 draws, in order, as
    ``multi_head_attention`` draws them."""
    gen = torch.Generator().manual_seed(12345)
    calls = [int(torch.randint(0, SEED_HIGH, (1,), generator=gen)) for _ in range(k)]
    after = gen.get_state()
    gen.manual_seed(12345)
    tape = SeedTape.draw(gen, k)
    assert tape.dtype == torch.int32 and tape.tolist() == calls
    assert torch.equal(gen.get_state(), after)


def test_seed_tape_hands_each_call_its_slot_and_fills_them_in_order():
    """While recording, each dropout call keeps its host draw and gets the
    next slot; the first load writes the capture's draws, the next the
    draws of as many per-call draws."""
    tape = SeedTape("cpu", capacity=4)
    gen = torch.Generator().manual_seed(7)
    drawn = []
    with tape.recording():
        for _ in range(3):
            seed = int(torch.randint(0, SEED_HIGH, (1,), generator=gen))
            drawn.append(seed)
            slot = SeedTape.active.take(seed)
            assert slot.data_ptr() == tape.slots[len(drawn) - 1:].data_ptr()
    assert SeedTape.active is None and tape.count == 3
    tape.load(gen)
    assert tape.slots[:3].tolist() == drawn
    state = gen.get_state()
    want = [int(torch.randint(0, SEED_HIGH, (1,), generator=gen)) for _ in range(3)]
    gen.set_state(state)
    tape.load(gen)
    assert tape.slots[:3].tolist() == want and tape.slots[3] == 0
    with tape.recording(), pytest.raises(RuntimeError, match="more than 4"):
        for _ in range(2):
            SeedTape.active.take(1)


@pytest.mark.parametrize("change", ["pointer", "shape", "stride", "dtype"])
def test_batch_key_changes_with_pointer_shape_stride_and_dtype(change):
    """Two batches of the same tensors share a key; a tensor at another
    address, of another shape, strides or dtype makes another key."""
    base = torch.zeros(4, 6)
    other = {"pointer": torch.zeros(4, 6), "shape": base.reshape(6, 4), "stride": base.t(),
             "dtype": base.view(torch.int32)}[change]
    mask = torch.zeros(4, dtype=torch.bool)
    key = batch_key({"x": base, "m": [mask, 3]})
    assert key == batch_key({"x": base, "m": [mask, 3]})
    assert batch_key({"x": other, "m": [mask, 3]}) != key


def test_batch_key_of_values_and_unhashable_leaves():
    """Other leaves count by value; an unhashable one gives no key."""
    x = torch.zeros(2)
    assert batch_key({"x": x, "n": 3}) != batch_key({"x": x, "n": 4})
    assert batch_key({"x": x, "n": [1]}) != batch_key({"x": x, "n": (1,)})
    assert batch_key({"x": x, "n": bytearray(b"a")}) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_drop_with_a_seed_slots_seed(dtype):
    """The hash bits of a seed slot equal those of its int seed, and the
    plain forward and backward give the same outputs with either."""
    seed = 1999999999
    slot = torch.tensor([seed], dtype=torch.int32)
    assert torch.equal(dropout_bits(slot, 2, 3, 5, 7, b0=4), dropout_bits(seed, 2, 3, 5, 7, b0=4))
    gen = torch.Generator().manual_seed(0)
    q, k, v, g = (torch.randn(2, n, 12, generator=gen).to(dtype) for n in (5, 9, 9, 5))
    out, stats = fused_mha_forward(q, k, v, 3, None, True, 0.3, seed)
    out_s, stats_s = fused_mha_forward(q, k, v, 3, None, True, 0.3, slot)
    assert torch.equal(out, out_s) and torch.equal(stats, stats_s)
    grads = fused_mha_backward(q, k, v, out, stats, g, 3, None, 0.3, seed)
    grads_s = fused_mha_backward(q, k, v, out, stats, g, 3, None, 0.3, slot)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_s))


def _fake_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=7))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_slot_launches_pass_the_slots_pointer(monkeypatch, direction, dtype):
    """A dropout launch over a seed slot passes its entry the slot's
    pointer beside a seed argument of 0; an int seed passes itself and a
    null slot, and so does a launch without dropout (fake library
    functions)."""
    bf16 = dtype == torch.bfloat16
    getter = f"_{direction}{'_bf16' if bf16 else ''}_fn"
    calls = []
    monkeypatch.setattr(attention, getter, lambda: lambda *a: calls.append(a) or 0)
    _fake_cuda(monkeypatch)
    b, l, s, h, d = 2, 50, 53, 8, 15
    q, k, v = (torch.zeros(b, n, h * d, dtype=dtype) for n in (l, s, s))
    stats = torch.zeros(b, l, 2 * h)
    slot = torch.tensor([77], dtype=torch.int32)
    n_before = 7 + (11 if bf16 else 9) if direction == "fwd" else 11 + (13 if bf16 else 9)
    threshold = attention.keep_threshold(0.1)
    for seed, rate, want in [(slot, 0.1, (0, slot.data_ptr(), threshold, 1.0 / 0.9, 3, 7)),
                             (77, 0.1, (77, None, threshold, 1.0 / 0.9, 3, 7)),
                             (None, 0.0, (0, None, 0, 1.0, 0, 7))]:
        if direction == "fwd":
            attention._launch_fwd(q, k, v, h, None, rate, seed, b0=3)
        else:
            attention._launch_bwd(q, k, v, q, stats, q, h, None, rate, seed, b0=3)
        assert calls[-1][n_before:] == want


def test_a_key_is_sighted_again_within_the_last_seen_keys():
    """A key counts as sighted again where it came within the last SEEN
    keys noted, or has a graph; no key (None) never does."""
    graphs = TrainStepGraphs([])
    assert not graphs.sighted(None) and not graphs.sighted(None)
    assert not graphs.sighted(("a",)) and not graphs.sighted(("b",))
    assert graphs.sighted(("a",)) and graphs.sighted(("b",))
    others = [("other", i) for i in range(SEEN)]
    assert not any(graphs.sighted(k) for k in others)
    assert not graphs.sighted(("a",))  # pushed out by SEEN other keys
    graphs._steps[("b",)] = None  # a key with a graph (or a failed capture)
    assert graphs.sighted(("b",))


def test_accumulator_zeroes_gradients_in_place():
    """After its optimizer step the gradients are zeros in the same
    tensors, so a replayed backward adds into them where they are."""
    lin = torch.nn.Linear(3, 2)
    acc = GradientAccumulator(torch.optim.AdamW(lin.parameters(), lr=0.1))
    lin(torch.ones(1, 3)).sum().backward()
    grads = [p.grad for p in lin.parameters()]
    assert acc.step()
    assert all(p.grad is g and not g.any() for p, g in zip(lin.parameters(), grads))


def test_cpu_trainer_runs_every_step_eagerly():
    """On the CPU no step is graphable: each is eager and counted so, with
    its spans' layout unchanged (the forward, backward and optimizer)."""
    trainer = _trainer("1x1", "cpu")
    before = _counts()
    batch = _batch(1)
    for _ in range(3):
        out = trainer.step(batch)
        assert torch.isfinite(out["loss"])
    assert not trainer.graphable() and len(trainer.graphs) == 0
    assert [a - b for a, b in zip(_counts(), before)] == [3, 0, 0]
    assert trainer.step_count == 3


def test_hooks_on_any_submodule_make_a_step_ungraphable():
    """A forward, pre-forward or backward hook anywhere in the model, or a
    global one, is seen (a replay would skip its Python)."""
    model = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.Sequential(torch.nn.ReLU()))
    from act3d_tpu_torch.train.engine import _hooked

    assert not _hooked(model)
    for register in (lambda m: m.register_forward_hook(lambda *a: None),
                     lambda m: m.register_forward_pre_hook(lambda *a: None),
                     lambda m: m.register_full_backward_hook(lambda *a: None)):
        handle = register(model[1][0])
        assert _hooked(model)
        handle.remove()
        assert not _hooked(model)
    handle = torch.nn.modules.module.register_module_forward_hook(lambda *a: None)
    try:
        assert _hooked(model)
    finally:
        handle.remove()


# ------------------------------------------------------------------ card
@pytest.fixture
def card():
    """Skips the test when no CUDA device is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


class _HostSeeds:
    """Stands in for a recording tape in eager steps: keeps each call's
    seed and hands it back as the int."""

    def __init__(self):
        self.seeds = []

    def take(self, seed):
        self.seeds.append(seed)
        return seed


@contextlib.contextmanager
def _recorded_draws(monkeypatch):
    """Every device draw of the loss (noise, timesteps, dropout masks), as
    a clone kept alive; a captured step's clones are rewritten by each of
    its replays."""
    from act3d_tpu_torch.models import diffusion_planner
    from act3d_tpu_torch.nn import dropout

    draws, real = [], dropout.draw

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        draws.append(out.clone())
        return out

    monkeypatch.setattr(dropout, "draw", recording)
    monkeypatch.setattr(diffusion_planner, "draw", recording)
    yield draws


def _draws_by_step(head, graphed, monkeypatch, steps=6):
    """Per step: (host seeds, device draws on the host) of ``steps`` steps
    on one batch, graphed (eager, capture, replay, ...) or all eager."""
    trainer = _trainer(head, "cuda")
    if not graphed:
        monkeypatch.setattr(trainer, "graphable", lambda: False)
    batch = _batch(3, "cuda")
    out = []
    with _recorded_draws(monkeypatch) as draws:
        captured = None
        for i in range(steps):
            host = _HostSeeds()
            del draws[:]
            SeedTape.active = host
            try:
                trainer.step(batch)
            finally:
                SeedTape.active = None
            torch.cuda.synchronize()
            if graphed and i > 0:
                tape = trainer.graphs._steps[batch_key(batch)].out[-1]  # (loss, aux, tape)
                captured = captured or list(draws)
                seeds = tape.slots[:tape.count].tolist()
                out.append((seeds, [d.cpu() for d in captured]))
            else:
                out.append((host.seeds, [d.cpu() for d in draws]))
    return out


@gpu
@pytest.mark.parametrize("head", sorted(HEADS))
def test_replayed_steps_draw_what_eager_steps_draw(card, monkeypatch, head):
    """Steps 1-6 run eager, capture, replay, replay, ... draw bitwise the
    host seeds, timesteps, noise and dropout masks of steps 1-6 run
    eagerly from the same seeds."""
    before = _counts()
    graphed = _draws_by_step(head, True, monkeypatch)
    assert [a - b for a, b in zip(_counts(), before)] == [1, 5, 1]
    eager = _draws_by_step(head, False, monkeypatch)
    for i, ((seeds_g, draws_g), (seeds_e, draws_e)) in enumerate(zip(graphed, eager)):
        assert seeds_g == seeds_e and len(seeds_e) > 0, i
        assert len(draws_g) == len(draws_e) > 0, i
        for a, b in zip(draws_g, draws_e):
            assert torch.equal(a, b), i
    assert eager[0][0] != eager[1][0]  # every step draws anew


def _state(trainer):
    return ([p.detach().clone() for p in trainer.model.parameters()],
            copy.deepcopy(trainer.optimizer.state_dict()),
            trainer.generators.host.get_state(), trainer.generators.device.get_state())


def _restore(trainer, state):
    params, opt, host, device = state
    with torch.no_grad():
        for p, saved in zip(trainer.model.parameters(), params):
            p.copy_(saved)
    trainer.optimizer.load_state_dict(copy.deepcopy(opt))
    trainer.generators.host.set_state(host)
    trainer.generators.device.set_state(device)


def _step_grads(trainer, batch, monkeypatch):
    """The loss and the gradients (before AdamW) of one step."""
    grads = []
    step = trainer.accumulator.step

    def keep():
        grads.extend(None if p.grad is None else p.grad.clone()
                     for p in trainer.model.parameters())
        return step()

    monkeypatch.setattr(trainer.accumulator, "step", keep)
    loss = trainer.step(batch)["loss"]
    monkeypatch.setattr(trainer.accumulator, "step", step)
    torch.cuda.synchronize()
    return loss, grads


def _gap(a, b):
    return max(((x - y).abs().max() / y.abs().max().clamp_min(1e-30)).item()
               for x, y in zip(a, b) if x is not None and y is not None)


def _one_step_case(case):
    """(Trainer, batch, the dropout calls of a step or None) at the tests'
    tiny widths of a head, or at a benchmark training cell's widths."""
    if case in HEADS:
        return _trainer(case, "cuda"), _batch(2, "cuda"), None
    head, dropout_calls = CELLS[case]
    torch.manual_seed(0)
    model = DiffusionPlanner(**CELL_CFG, **head, device="cuda")
    trainer = Trainer(diffusion_loss_fn(model), model, lr=1e-4, weight_decay=5e-4, seed=11)
    batch = {k: v.to("cuda") for k, v in
             synthetic_trajectory_batch(22, 3, (256, 256), 50, seed=4).items()}
    return trainer, batch, dropout_calls


@gpu
@pytest.mark.parametrize("case", sorted(HEADS) + sorted(CELLS))
def test_one_step_replayed_equals_eager(card, monkeypatch, case):
    """From one state and one batch, at tiny widths and at the benchmark
    training cells' (batch 22, 3 cameras at 256^2, trajectory length 50,
    embedding 120, 6 query layers, dropout 0.1): the replayed step makes
    the step's dropout calls from its seed slots, its loss is the eager
    loss bitwise, and its gradients lie as near an eager run's as eager
    runs lie to each other (the backward is not bit-reproducible)."""
    trainer, batch, dropout_calls = _one_step_case(case)
    trainer.step(batch)  # eager: warms the Trainer, and the batch is seen
    state = _state(trainer)
    before = _counts()
    loss_g, grads_g = _step_grads(trainer, batch, monkeypatch)
    assert [a - b for a, b in zip(_counts(), before)] == [0, 1, 1]
    if dropout_calls is not None:
        assert trainer.graphs._steps[batch_key(batch)].out[-1].count == dropout_calls
    monkeypatch.setattr(trainer, "graphable", lambda: False)
    eager = []
    for _ in range(3):
        _restore(trainer, state)
        eager.append(_step_grads(trainer, batch, monkeypatch))
    for loss_e, _ in eager:
        assert torch.equal(loss_g, loss_e), (loss_g - loss_e).item()
    spread = max(_gap(eager[i][1], eager[j][1]) for i in range(3) for j in range(i + 1, 3))
    nearest = min(_gap(grads_g, grads_e) for _, grads_e in eager)
    print(f"{case}: loss {loss_g.item():.6f}; replayed vs eager gradients {nearest:.3e}, "
          f"eager spread {spread:.3e}")
    assert nearest <= spread, (nearest, spread)


@gpu
def test_hooks_and_accumulation_keep_steps_eager(card):
    """A forward hook on a submodule, or accumulate_grad_batches 2: every
    step eager, no capture."""
    trainer = _trainer("1x1", "cuda")
    submodule = next(m for m in trainer.model.modules() if m is not trainer.model)
    handle = submodule.register_forward_hook(lambda *a: None)
    batch = _batch(1, "cuda")
    before = _counts()
    for _ in range(3):
        trainer.step(batch)
    assert [a - b for a, b in zip(_counts(), before)] == [3, 0, 0]
    handle.remove()
    trainer.step(batch)
    assert [a - b for a, b in zip(_counts(), before)] == [3, 1, 1]
    accumulating = _trainer("1x1", "cuda", accumulate_grad_batches=2)
    before = _counts()
    for _ in range(4):
        accumulating.step(batch)
    assert [a - b for a, b in zip(_counts(), before)] == [4, 0, 0]


@gpu
def test_a_fifth_batch_runs_eagerly_and_load_checkpoint_drops_the_graphs(card, tmp_path):
    """Batches 0-4 once: eager, each a first sighting; again: 0-3 captured,
    4 finds ENTRIES graphs and runs eagerly; 0 replays.  load_checkpoint
    drops every graph (1, seen, is captured anew at once), and so does a
    gradient set to None (that step runs eagerly).  Other tensors each
    step, of the same values: never captured."""
    trainer = _trainer("1x1", "cuda")
    batches = [_batch(i, "cuda") for i in range(ENTRIES + 1)]
    before = _counts()
    for batch in batches:
        trainer.step(batch)
    assert [a - b for a, b in zip(_counts(), before)] == [ENTRIES + 1, 0, 0]
    for batch in batches:
        trainer.step(batch)
    assert [a - b for a, b in zip(_counts(), before)] == [ENTRIES + 2, ENTRIES, ENTRIES]
    trainer.step(batches[0])
    assert [a - b for a, b in zip(_counts(), before)] == [ENTRIES + 2, ENTRIES + 1, ENTRIES]
    trainer.save_checkpoint(tmp_path)
    trainer.load_checkpoint(tmp_path / "last.pt")
    assert len(trainer.graphs) == 0
    trainer.step(batches[1])
    assert [a - b for a, b in zip(_counts(), before)] == [ENTRIES + 2, ENTRIES + 2, ENTRIES + 1]
    trainer.model.zero_grad(set_to_none=True)  # the graphs' gradients are gone
    trainer.step(batches[1])
    assert len(trainer.graphs) == 0
    trainer.step(batches[1])
    assert [a - b for a, b in zip(_counts(), before)] == [ENTRIES + 3, ENTRIES + 3, ENTRIES + 2]
    fresh = _trainer("1x1", "cuda")
    clones = [{k: v.clone() for k, v in batches[i % 2].items()} for i in range(3)]
    before = _counts()
    for batch in clones:
        fresh.step(batch)
    assert [a - b for a, b in zip(_counts(), before)] == [3, 0, 0]


@gpu
def test_a_failed_capture_leaves_the_generators_where_eager_would(card):
    """A loss that reads a number on the host cannot be captured: the step
    runs eagerly, the key stays eager, and the generators after each step
    are those of an all-eager run."""
    def host_reading(trainer):
        loss_fn = trainer._loss_fn

        def loss_host(batch, generators):
            loss, aux = loss_fn(batch, generators)
            return loss, {"host": float(loss.detach())}

        trainer._loss_fn = loss_host
        return trainer

    graphed, eager = host_reading(_trainer("1x1", "cuda")), host_reading(_trainer("1x1", "cuda"))
    eager.graphable = lambda: False
    batch = _batch(1, "cuda")
    before = _counts()
    with pytest.warns(UserWarning, match="not captured, runs eagerly"):
        for _ in range(3):
            a, b = graphed.step(batch), eager.step(batch)
            assert a["host"] == b["host"]
            for gen_a, gen_b in ((graphed.generators.host, eager.generators.host),
                                 (graphed.generators.device, eager.generators.device)):
                assert torch.equal(gen_a.get_state(), gen_b.get_state())
    assert [a - b for a, b in zip(_counts(), before)] == [6, 0, 0]
    assert list(graphed.graphs._steps.values()) == [None]


@gpu
@pytest.mark.parametrize("head", sorted(HEADS))
def test_replays_count_what_eager_steps_count(card, head):
    """A replayed step adds to the attention calls, the kernels' launches,
    the denoiser evaluations and the selections what an eager step adds:
    4 selections an evaluation in the 3 x 2 head, none in the 1 x 1."""
    counters = graphs.COUNTERS
    trainer = _trainer(head, "cuda")
    batch = _batch(1, "cuda")
    per_step = []
    for _ in range(4):
        start = [getattr(o, n) for o, n in counters]
        trainer.step(batch)
        per_step.append([getattr(o, n) - s for (o, n), s in zip(counters, start)])
    assert per_step[0] == per_step[1] == per_step[2] == per_step[3]
    counted = dict(zip([(o.__name__, n) for o, n in counters], per_step[0]))
    assert counted[("multi_head_attention", "calls")] > 0
    assert counted[("fused_mha_forward", "launches")] == counted[("fused_mha_backward", "launches")]
    evaluations = counted[("DiffusionHead", "evaluations")]
    assert evaluations == 1
    assert counted[("find_traj_nn", "calls")] == (4 if head == "3x2" else 0) * evaluations


# the ChainedDiffuser training sites (B, L, S, H, d) at batch 22, with the
# multi-scale head's; the self-attention site with a padding mask; and one
# query row, which sends the bf16 forward to its mma.sync body
SLOT_SITES = [(22, 3072, 53, 8, 15), (22, 50, 53, 8, 15), (22, 50, 3074, 8, 15),
              (22, 50, 50, 8, 15), (22, 50, 3202, 8, 15), (22, 50, 802, 8, 15),
              (22, 3200, 53, 8, 15), (22, 800, 53, 8, 15), (22, 1, 3074, 8, 15)]


def _site_inputs(site, dtype, seed=0):
    b, l, s, h, d = site
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g = (torch.randn(b, n, h * d, generator=gen, device="cuda").to(dtype)
                  for n in (l, s, s, l))
    mask = None
    if l == s:
        mask = torch.zeros(b, s, dtype=torch.bool, device="cuda")
        mask[:, -7:] = True
    return q, k, v, g, mask


@gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", SLOT_SITES)
def test_seed_slot_launches_equal_seed_argument_launches(card, site, dtype):
    """Forward (out, stats) and backward (dq, dk, dv) launched over a seed
    slot are bitwise those launched with the seed argument, float32 and
    bf16, whichever body the plan picks."""
    q, k, v, g, mask = _site_inputs(site, dtype)
    h = site[3]
    seed = 1876543210
    slot = torch.tensor([seed], dtype=torch.int32, device="cuda")
    out, stats = attention._launch_fwd(q, k, v, h, mask, 0.1, seed)
    out_s, stats_s = attention._launch_fwd(q, k, v, h, mask, 0.1, slot)
    assert torch.equal(out, out_s) and torch.equal(stats, stats_s)
    grads = attention._launch_bwd(q, k, v, out, stats, g, h, mask, 0.1, seed)
    grads_s = attention._launch_bwd(q, k, v, out, stats, g, h, mask, 0.1, slot)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_s))
    if dtype == torch.bfloat16:
        print(site, type(fwd_plan_bf16(*site)).__name__)


@gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_graph_of_slot_launches_drops_with_the_seed_the_slot_holds(card, dtype):
    """Captured once over a slot, forward and backward replay with the
    seed written to the slot before each replay, bitwise as the
    seed-argument launches of that seed."""
    site = (22, 50, 3074, 8, 15)
    q, k, v, g, mask = _site_inputs(site, dtype, seed=1)
    h = site[3]
    slot = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        attention._launch_fwd(q, k, v, h, mask, 0.1, slot)  # warm
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out, stats = attention._launch_fwd(q, k, v, h, mask, 0.1, slot)
            grads = attention._launch_bwd(q, k, v, out, stats, g, h, mask, 0.1, slot)
        for seed in (5, 2**31 - 2, 123456789):
            slot.fill_(seed)
            graph.replay()
            want_out, want_stats = attention._launch_fwd(q, k, v, h, mask, 0.1, seed)
            want = attention._launch_bwd(q, k, v, want_out, want_stats, g, h, mask, 0.1, seed)
            torch.cuda.synchronize()
            assert torch.equal(out, want_out) and torch.equal(stats, want_stats), seed
            assert all(torch.equal(a, b) for a, b in zip(grads, want)), seed
