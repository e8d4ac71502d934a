"""The ChainedDiffuser training step of the port against the JAX package on
the CPU.

Small configuration: 64^2 images, 2 cameras, emb 24, 3 query layers,
trajectory length 8, batch 2 with padded (zero-filled) rows in one batch
row, instructions and goal on.  JAX's own draws of noise and timesteps
(``k_noise, k_time = split(noise_rng)``) are injected into the port, and
dropout is off on both sides (``deterministic=True`` / ``model.eval()``).
The loss must agree at 1e-4 relative and every non-backbone gradient at
atol 1e-4 / rtol 1e-3 (the full-model bound of tests/README.md), compared
by name through ``diffusion_planner_from_flax`` applied to JAX's gradient
tree.  Then the optimizer against ``act3d_tpu.train.optim`` and the Trainer.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from act3d_tpu.models import DiffusionPlanner as JDiffusionPlanner
from act3d_tpu.train.optim import make_optimizer as jax_make_optimizer
from act3d_tpu_torch.convert import diffusion_planner_from_flax
from act3d_tpu_torch.models import DiffusionPlanner
from act3d_tpu_torch.train.engine import Trainer
from act3d_tpu_torch.train.flagship import diffusion_loss_fn, diffusion_metrics_fn
from act3d_tpu_torch.train.optim import GradientAccumulator, make_optimizer
from act3d_tpu_torch.utils.testing import BOUNDS, synthetic_trajectory_batch

from tests.torch_parity import close, random_params, t

NCAM, IMAGE, N_INSTR, LENGTH, BATCH, STEPS = 2, 64, 7, 8, 2, 10
CFG = dict(image_size=(IMAGE, IMAGE), embedding_dim=24, output_dim=7,
           num_query_cross_attn_layers=3, num_vis_ins_attn_layers=1,
           use_instruction=True, use_goal=True, use_goal_at_test=False,
           diffusion_timesteps=STEPS, gripper_loc_bounds=BOUNDS)
KEYS = ("trajectory", "trajectory_mask", "rgbs", "pcds", "instr", "curr_gripper", "action")


def _batch(seed):
    batch = synthetic_trajectory_batch(BATCH, NCAM, (IMAGE, IMAGE), LENGTH, seed=seed)
    batch["instr"] = batch["instr"][:, :N_INSTR]
    batch["trajectory_mask"][1, -3:] = True  # padded rows, zero-filled as the dataset does
    batch["trajectory"][1, -3:] = 0.0
    return {k: v.numpy() for k, v in batch.items()}


@pytest.fixture(scope="module")
def planner():
    jm = JDiffusionPlanner(**CFG)
    batch = _batch(0)
    params = random_params(jm, 21, *(batch[k] for k in KEYS), noise_rng=jax.random.PRNGKey(0))
    return jm, params


def _port(params):
    port = DiffusionPlanner(**CFG, device="cpu")
    port.load_state_dict(diffusion_planner_from_flax(params), strict=True)
    return port


def test_loss_and_gradients_match_jax(planner):
    jm, params = planner
    batch = _batch(1)
    key = jax.random.PRNGKey(3)

    def loss(p):
        return jm.apply({"params": p}, *(jnp.asarray(batch[k]) for k in KEYS),
                        noise_rng=key, deterministic=True)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss))(params)
    k_noise, k_time = jax.random.split(key)
    noise = jax.random.normal(k_noise, (BATCH, LENGTH, 9), dtype=jnp.float32)
    timesteps = jax.random.randint(k_time, (BATCH,), 0, STEPS)

    port = _port(params).eval()
    with pytest.raises(ValueError, match="generator"):
        port(*(t(batch[k]) for k in KEYS), noise=t(noise))
    got = port(*(t(batch[k]) for k in KEYS), noise=t(noise), timesteps=t(timesteps))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want_loss), rtol=1e-4)

    want = diffusion_planner_from_flax(jax.device_get(want_grads))
    checked = 0
    for name, param in port.named_parameters():
        if "backbone" in name:
            continue
        if param.grad is None:  # unused here (FPN levels of other scales)
            assert not want[name].any(), name
            continue
        close(param.grad, want[name].numpy(), 1e-4, 1e-3)
        checked += 1
    assert checked > 100, checked


@pytest.mark.parametrize("flatten", [False, True])
def test_adamw_matches_jax_optimizer(planner, flatten):
    """Three AdamW steps from the same params and gradients: the decay and
    no-decay groups as in JAX, and no update of the frozen backbone."""
    import optax

    _, params = planner
    lr, wd = 1e-3, 5e-4
    rng = np.random.default_rng(4)
    grads = [jax.tree_util.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32),
                                    params) for _ in range(3)]
    tx = jax_make_optimizer(params, lr=lr, weight_decay=wd, flatten=flatten)
    state = tx.init(params)
    jparams = params
    for g in grads:
        updates, state = tx.update(g, state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    port = _port(params)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    opt = make_optimizer(port, lr=lr, weight_decay=wd)
    named = dict(port.named_parameters())
    decay, no_decay = (group["params"] for group in opt.param_groups)
    assert [g["weight_decay"] for g in opt.param_groups] == [wd, 0.0]
    assert all(p.ndim > 1 for p in decay) and all(p.ndim <= 1 for p in no_decay)
    in_opt = {id(p) for p in decay + no_decay}
    for name, p in named.items():
        assert (("backbone" in name) != p.requires_grad) and (p.requires_grad == (id(p) in in_opt))
    for g in grads:
        tg = diffusion_planner_from_flax(g)
        for name, p in named.items():
            if p.requires_grad:
                p.grad = tg[name]
        opt.step()

    want = diffusion_planner_from_flax(jax.device_get(jparams))
    for name, p in named.items():
        close(p.detach(), want[name].numpy(), 1e-6)
        if "backbone" in name:
            assert torch.equal(p, before[name])


def test_gradient_accumulation_averages_micro_batches():
    """Two micro-batches with every_k=2 step once, on the mean gradient."""
    torch.manual_seed(0)
    lin = torch.nn.Linear(3, 2)
    twin = torch.nn.Linear(3, 2)
    twin.load_state_dict(lin.state_dict())
    acc = GradientAccumulator(make_optimizer(lin, lr=0.1), every_k=2)
    opt = make_optimizer(twin, lr=0.1)
    xs = torch.randn(2, 4, 3)
    w0 = lin.weight.detach().clone()
    lin(xs[0]).square().sum().backward()
    assert acc.step() is False and torch.equal(lin.weight, w0)
    lin(xs[1]).square().sum().backward()
    assert acc.step() is True
    ((twin(xs[0]).square().sum() + twin(xs[1]).square().sum()) / 2).backward()
    opt.step()
    torch.testing.assert_close(lin.weight, twin.weight, atol=1e-7, rtol=0)
    assert not lin.weight.grad.any()  # zeroed in place for the next micro-batches


def test_dropout_follows_training_mode_and_generators():
    from act3d_tpu_torch.nn.dropout import Generators, dropout
    from act3d_tpu_torch.nn.layers import ParallelAttentionLayer

    torch.manual_seed(0)
    layer = ParallelAttentionLayer(d_model=24, n_heads=4, self_attention2=False,
                                   cross_attention2=False, dropout=0.1)
    x, y = torch.randn(2, 5, 24), torch.randn(2, 7, 24)
    with pytest.raises(ValueError, match="generators"):
        layer(x, y)  # training mode, the module default, without generators
    a, _ = layer(x, y, generators=Generators.from_seed(3, "cpu"))
    assert torch.equal(a, layer(x, y, generators=Generators.from_seed(3, "cpu"))[0])
    assert not torch.equal(a, layer(x, y, generators=Generators.from_seed(4, "cpu"))[0])
    layer.eval()
    assert torch.equal(layer(x, y, generators=Generators.from_seed(3, "cpu"))[0],
                       layer(x, y)[0])

    ones = torch.ones(200_000)
    dropped = dropout(ones, 0.1, Generators.from_seed(5, "cpu"))
    torch.testing.assert_close(dropped[dropped != 0], torch.full_like(ones, 1 / 0.9)[dropped != 0])
    assert abs((dropped > 0).float().mean().item() - 0.9) < 0.005
    assert dropout(ones, 0.1, None) is ones


def test_graceful_shutdown_records_sigterm_and_restores_the_handler():
    import os
    import signal

    from act3d_tpu_torch.train.engine import GracefulShutdown

    before = signal.getsignal(signal.SIGTERM)
    with GracefulShutdown() as stop:
        assert not stop.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert stop.requested
    assert signal.getsignal(signal.SIGTERM) is before


def _torch_batch(seed):
    return {k: torch.from_numpy(v) for k, v in _batch(seed).items()}


def test_trainer_step_checkpoint_roundtrip_and_best_rule(planner, tmp_path):
    _, params = planner
    model = _port(params)
    trainer = Trainer(diffusion_loss_fn(model), model, metrics_fn=diffusion_metrics_fn(model),
                      lr=1e-3, log_dir=tmp_path / "logs", seed=5)
    params0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    buffers0 = {k: v.clone() for k, v in model.named_buffers()}
    out = trainer.step(_torch_batch(2))
    assert torch.isfinite(out["loss"]) and trainer.step_count == 1
    changed = 0
    for name, p in model.named_parameters():
        if "backbone" in name:
            assert torch.equal(p, params0[name]), name
        else:
            changed += not torch.equal(p, params0[name])
    assert changed > 100, changed
    for name, buf in model.named_buffers():
        assert torch.equal(buf, buffers0[name]), name

    metrics = trainer.evaluate([_torch_batch(3)])
    assert np.isfinite(metrics["noise_mse"]) and not model.training
    trainer.logger.log(trainer.step_count, {"loss": out["loss"], **metrics})

    ckpt = tmp_path / "ckpt"
    trainer.save_checkpoint(ckpt, new_loss=2.0)
    assert (ckpt / "best.pt").exists() and trainer.best_loss == 2.0
    trainer.step(_torch_batch(4))
    trainer.save_checkpoint(ckpt, new_loss=3.0)  # worse: best.pt keeps step 1
    assert trainer.best_loss == 2.0
    assert torch.load(ckpt / "best.pt", weights_only=True)["step"] == 1
    trainer.save_checkpoint(ckpt, new_loss=2.0)  # ties count as best (<=)
    assert torch.load(ckpt / "best.pt", weights_only=True)["step"] == 2
    trainer.save_checkpoint(ckpt, last_only=True)

    fresh_model = _port(params)
    fresh = Trainer(diffusion_loss_fn(fresh_model), fresh_model, lr=1e-3)
    fresh.load_checkpoint(ckpt / "last.pt")
    assert fresh.step_count == 2 and fresh.best_loss == 2.0
    for (name, a), b in zip(model.state_dict().items(), fresh_model.state_dict().values()):
        assert torch.equal(a, b), name
    s_a, s_b = trainer.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert s_a["param_groups"] == s_b["param_groups"]
    for i, st in s_a["state"].items():
        for k, v in st.items():
            assert torch.equal(v, s_b["state"][i][k]), (i, k)
