"""The port's training host path against the JAX package, on the CPU.

* ``compact_batch`` bit-identical to JAX's (u16 and f16 pcds, u16 depth,
  with a pixel beyond 6.4 m: the depth wire clamps it to 6.4 m in both);
  ``expand_batch`` exact against JAX's for u8 / u16 / f16 / depth batches,
  and the identity on float batches.
* ``gather_hw`` exact against JAX; ``reconstruct_pcds`` within 1e-6 of
  JAX, and the whole depth wire (dataset -> compact -> expand) within
  ``WIRE_TOL`` of the XYZ wire's batch of the same draws.
* ``resize_with_params`` bit-identical to the port's host ``Resize`` and to
  JAX's at four scales; ``yaw_rotate_batch`` with injected yaws against the
  host ``Rotate`` and JAX, and a batch whose every try is rejected keeps
  its input; ``make_device_augment`` draws in its documented order.
* ``RLBenchDataset`` batches under ``wire="depth"``, ``instr_mode="ids"``,
  ``augment_host=False`` and ``get_chunk`` bit-identical to JAX's on the
  same tree and seed; ``instruction_bank`` row-equal; the pinhole
  fallback and the load-time check.
* The loss functions: ``instr_id`` + ``instr_bank`` and a compact batch
  give the canonical batch's loss; ``instr_id`` without a bank raises.
* ``train/viz.py`` draws JAX's images.
JAX runs on the CPU, as its own tests run it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from act3d_tpu_torch.data import augment as port_augment
from act3d_tpu_torch.data.compact import DEPTH_U16_RANGE, compact_batch, expand_batch
from act3d_tpu_torch.data.dataset import RLBenchDataset
from act3d_tpu_torch.data.depthwire import gather_hw, reconstruct_pcds
from act3d_tpu_torch.data.device_augment import (
    make_device_augment,
    resize_sample,
    resize_with_params,
    yaw_rotate_batch,
)
from act3d_tpu_torch.data.episode import load_episode, save_episode
from act3d_tpu_torch.data.fixtures import CAMERAS, make_dataset_tree, make_instructions

TASKS = ("pick_and_lift", "push_button")
WIRE_TOL = 5e-4  # u16 depth step x |K^-1 u| (tests/test_depthwire.py)
BOUNDS = np.array([[-0.5, -0.5, 0.0], [0.9, 0.9, 1.6]])


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_tree(batch):
    return {k: jnp.asarray(v) for k, v in batch.items() if k != "task"}


def _port_tree(batch):
    return {k: _t(v) for k, v in batch.items() if k != "task"}


class _FixedRng:
    """np.random.Generator stand-in with scripted draws."""

    def __init__(self, uniforms, integers=()):
        self._uniforms, self._integers = list(uniforms), list(integers)

    def uniform(self, *a, **k):
        return self._uniforms.pop(0)

    def integers(self, low, high=None, *a, **k):
        return self._integers.pop(0)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """2 tasks x 2 episodes of 3 frames, 2 of 3 cameras at 32^2, written by
    the port's fixture writer (JAX's writes the same bytes)."""
    root = tmp_path_factory.mktemp("host_path")
    make_dataset_tree(root / "data", tasks=TASKS, variations=(0,), episodes_per_variation=2,
                      n_frames=3, n_cam=3, image_size=32, seed=7)
    return root / "data", make_instructions(TASKS, (0,), n_instr=3, seed=8)


def _ds_args(tree, **over):
    root, instructions = tree
    args = dict(root=root, instructions=instructions, taskvar=[(t, 0) for t in TASKS],
                cameras=("left_shoulder", "wrist"), cache_size=4, training=True,
                image_rescale=(0.75, 1.25), point_cloud_rotate_yaw_range=15.0,
                gripper_loc_bounds=BOUNDS, return_low_lvl_trajectory=True,
                dense_interpolation=True, interpolation_length=8, action_dim=7, seed=3)
    args.update(over)
    return args


# ------------------------------------------------------------------ compact
@pytest.mark.parametrize("pcd_mode", ["u16", "f16"])
def test_compact_batch_is_bit_identical_to_jax(pcd_mode):
    from act3d_tpu.data.compact import compact_batch as jax_compact

    rng = np.random.default_rng(0)
    batch = {
        "rgbs": rng.uniform(-0.1, 1.1, (2, 3, 3, 8, 8)).astype(np.float32),
        "pcds": rng.uniform(-4.0, 4.0, (2, 3, 3, 8, 8)).astype(np.float32),
        "depth": rng.uniform(0.0, 8.0, (2, 3, 8, 8)).astype(np.float32),
        "action": rng.normal(size=(2, 8)).astype(np.float32),
        "task": ["a", "b"],
    }
    batch["depth"][0, 0, 0, 0] = 9.5  # beyond DEPTH_U16_RANGE
    got, want = compact_batch(batch, pcd_mode), jax_compact(batch, pcd_mode)
    assert list(got) == list(want)
    for k in want:
        if k == "task":
            assert got[k] == want[k]
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["pcds"].dtype == (np.uint16 if pcd_mode == "u16" else np.float16)
    # the depth wire clamps silently: 9.5 m decodes as the range's top
    assert got["depth"][0, 0, 0, 0] == 65535
    assert expand_batch({"depth": _t(got["depth"])})["depth"][0, 0, 0, 0] == \
        np.float32(DEPTH_U16_RANGE[1])
    with pytest.raises(ValueError, match="pcd_mode"):
        compact_batch(batch, "u8")


def _expand_case(name, rng):
    u8 = rng.integers(0, 256, (2, 3, 3, 8, 8), dtype=np.uint8)
    if name == "u8":
        return {"rgbs": u8}
    if name == "u16":
        return {"pcds": rng.integers(0, 65536, (2, 3, 3, 8, 8), dtype=np.uint16), "rgbs": u8}
    if name == "f16":
        return {"pcds": rng.uniform(-2, 2, (2, 3, 3, 8, 8)).astype(np.float16)}
    # depth wire: u16 depth + cameras + index maps
    intr = np.tile(np.array([[9.6, 0, 3.5], [0, 9.6, 3.5], [0, 0, 1]], np.float32), (2, 3, 1, 1))
    c2w = np.tile(np.eye(4, dtype=np.float32), (2, 3, 1, 1))
    c2w[..., :3, 3] = rng.normal(size=(2, 3, 3))
    return {"rgbs": u8, "depth": rng.integers(0, 65536, (2, 3, 8, 8), dtype=np.uint16),
            "cam_intr": intr, "cam_c2w": c2w,
            "aug_rows": rng.integers(0, 8, (2, 8)).astype(np.int32),
            "aug_cols": rng.integers(0, 8, (2, 8)).astype(np.int32)}


@pytest.mark.parametrize("name", ["u8", "u16", "f16", "depth"])
def test_expand_batch_matches_jax(name):
    from act3d_tpu.data.compact import expand_batch as jax_expand

    batch = _expand_case(name, np.random.default_rng(1))
    got, want = expand_batch(_port_tree(batch)), jax_expand(_jax_tree(batch))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        if name == "depth" and k == "pcds":  # the reconstruction's float sums
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_expand_batch_is_identity_on_float_batches():
    batch = {"rgbs": torch.rand(1, 2, 3, 4, 4), "pcds": torch.randn(1, 2, 3, 4, 4),
             "action": torch.zeros(1, 8)}
    out = expand_batch(batch)
    assert all(out[k] is batch[k] for k in batch)


# ---------------------------------------------------------------- depthwire
def test_gather_hw_is_exact_against_jax():
    from act3d_tpu.data.depthwire import gather_hw as jax_gather

    rng = np.random.default_rng(2)
    a = rng.normal(size=(2, 3, 4, 8, 10)).astype(np.float32)
    rows = rng.integers(0, 8, (2, 8)).astype(np.int32)
    cols = rng.integers(0, 10, (2, 10)).astype(np.int32)
    got = gather_hw(_t(a), _t(rows), _t(cols)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_gather(jnp.asarray(a), rows, cols)))
    np.testing.assert_array_equal(
        got, np.stack([a[i][..., rows[i][:, None], cols[i][None, :]] for i in range(2)]))


@pytest.mark.parametrize("maps", [False, True], ids=["no_maps", "maps"])
def test_reconstruct_pcds_matches_jax(tree, maps):
    from act3d_tpu.data.depthwire import reconstruct_pcds as jax_reconstruct

    batch = RLBenchDataset(**_ds_args(tree, wire="depth", training=maps)).sample_batch(3)
    assert ("aug_rows" in batch) == maps
    args = [batch["depth"], batch["cam_intr"], batch["cam_c2w"]]
    kw = dict(rows=batch["aug_rows"], cols=batch["aug_cols"]) if maps else {}
    got = reconstruct_pcds(*map(_t, args), **{k: _t(v) for k, v in kw.items()})
    want = jax_reconstruct(*map(jnp.asarray, args), **{k: jnp.asarray(v) for k, v in kw.items()})
    assert got.shape == (3, 2, 3, 32, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("training", [True, False], ids=["augmented", "eval"])
def test_depth_wire_rebuilds_the_xyz_batch_of_the_same_draws(tree, training):
    host = RLBenchDataset(**_ds_args(tree, training=training)).sample_batch(6)
    ds = RLBenchDataset(**_ds_args(tree, wire="depth", training=training))
    assert ds.wire == "depth"
    wire = ds.sample_batch(6)
    assert "pcds" not in wire and "depth" in wire
    enc = compact_batch(wire)
    assert enc["depth"].dtype == np.uint16 and enc["rgbs"].dtype == np.uint8
    out = expand_batch(_port_tree(enc))
    np.testing.assert_allclose(out["pcds"].numpy(), host["pcds"], atol=WIRE_TOL)
    np.testing.assert_allclose(out["rgbs"].numpy(), host["rgbs"], atol=0.5 / 255 + 1e-6)
    for k in ("action", "curr_gripper", "trajectory"):  # the same rotation draw
        np.testing.assert_array_equal(wire[k], host[k])


# ----------------------------------------------------------- device augment
@pytest.mark.parametrize("scale", [0.75, 0.9, 1.1, 1.25])
def test_resize_with_params_equals_host_resize_and_jax(scale):
    from act3d_tpu.data.device_augment import resize_with_params as jax_resize

    rng = np.random.default_rng(3)
    h = w = 32
    rgbs = rng.uniform(0, 1, (2, 3, h, w)).astype(np.float32)
    pcds = rng.normal(size=(2, 3, h, w)).astype(np.float32)
    crop_max = max(int(h * scale) - h, 0)
    crops = [(min(crop_max, 3), min(crop_max, 1)), (crop_max, 0)]
    got = resize_with_params({"rgbs": _t(rgbs), "pcds": _t(pcds)}, scale,
                             torch.tensor([c[0] for c in crops]),
                             torch.tensor([c[1] for c in crops]))
    for b, (ci, cj) in enumerate(crops):
        host = port_augment.Resize(scales=(scale, scale), rng=_FixedRng([scale], [ci, cj]))(
            rgbs=rgbs[b], pcds=pcds[b])
        ref = jax_resize({"rgbs": jnp.asarray(rgbs[b]), "pcds": jnp.asarray(pcds[b])},
                         jnp.float32(scale), jnp.int32(ci), jnp.int32(cj))
        for k in ("rgbs", "pcds"):
            np.testing.assert_array_equal(got[k][b].numpy(), host[k])
            np.testing.assert_array_equal(got[k][b].numpy(), np.asarray(ref[k]))


def _poses(rng, b):
    g = rng.normal(size=(b, 8)).astype(np.float32)
    g[:, :3] = rng.uniform(-0.4, 0.4, (b, 3))
    g[:, 3:7] /= np.linalg.norm(g[:, 3:7], axis=-1, keepdims=True)
    a = g.copy()
    a[:, :3] += rng.uniform(-0.1, 0.1, (b, 3)).astype(np.float32)
    return g, a


def test_yaw_rotate_batch_matches_host_rotate_and_jax():
    from act3d_tpu.data.device_augment import yaw_rotate_batch as jax_rotate

    rng = np.random.default_rng(4)
    b, tries, yaw_range = 3, 10, 30.0
    g, a = _poses(rng, b)
    g[1, :3] = [1.2, 0.0, 0.5]  # out of bounds for most yaws: a later try wins
    a[1, :3] = [1.2, 0.0, 0.5]
    pcds = rng.normal(size=(b, 2, 3, 6, 6)).astype(np.float32)
    bounds = np.array([[-1.3, -0.5, -1.0], [1.3, 1.3, 1.0]], np.float32)
    rad = np.deg2rad(yaw_range)
    yaws = rng.uniform(-rad, rad, (b, tries))
    got_p, got = yaw_rotate_batch(None, _t(pcds), {"curr_gripper": _t(g), "action": _t(a)},
                                  yaw_range_rad=rad, bounds=_t(bounds),
                                  yaws=_t(yaws.astype(np.float32)))
    ref_p, ref = jax_rotate(None, jnp.asarray(pcds),
                            {"curr_gripper": jnp.asarray(g), "action": jnp.asarray(a)},
                            yaw_range_rad=rad, bounds=jnp.asarray(bounds),
                            yaws=jnp.asarray(yaws, jnp.float32))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), **tol)
    for k in ("curr_gripper", "action"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), **tol)
    for i in range(b):  # the host Rotate over the same yaw draws, one sample at a time
        rot = port_augment.Rotate(bounds.astype(np.float64), yaw_range, num_tries=tries,
                                  rng=_FixedRng(list(yaws[i])))
        p_h, g_h, a_h, _ = rot(pcds[i:i + 1], g[i:i + 1], a[i:i + 1])
        np.testing.assert_allclose(got_p[i:i + 1].numpy(), p_h, **tol)
        np.testing.assert_allclose(got["curr_gripper"][i:i + 1].numpy(), g_h, **tol)
        np.testing.assert_allclose(got["action"][i:i + 1].numpy(), a_h, **tol)
    assert not np.allclose(got_p.numpy(), pcds)


def test_yaw_rotate_batch_keeps_the_input_when_every_try_is_rejected():
    rng = np.random.default_rng(5)
    g, a = _poses(rng, 2)
    g[0, :3] = [0.99, 0.99, 0.0]  # sample 0: in bounds only near yaw 0
    pcds = rng.normal(size=(2, 1, 3, 4, 4)).astype(np.float32)
    bounds = _t(np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32))
    yaws = torch.tensor([[0.4, -0.5, 0.6], [0.3, 0.2, 0.1]])
    traj = _t(rng.normal(size=(2, 5, 8)).astype(np.float32))
    p_out, out = yaw_rotate_batch(None, _t(pcds), {"curr_gripper": _t(g), "action": _t(a),
                                                   "trajectory": traj},
                                  yaw_range_rad=0.7, bounds=bounds, num_tries=3, yaws=yaws)
    assert torch.equal(p_out[0], _t(pcds[0]))
    assert torch.equal(out["curr_gripper"][0], _t(g[0])) and torch.equal(out["trajectory"][0],
                                                                          traj[0])
    assert not torch.allclose(p_out[1], _t(pcds[1]))  # sample 1 takes its first try


def test_make_device_augment_draws_in_its_documented_order():
    rng = np.random.default_rng(6)
    g, a = _poses(rng, 3)
    batch = {"rgbs": torch.rand(3, 2, 3, 16, 16), "pcds": _t(rng.normal(size=(3, 2, 3, 16, 16))
                                                          .astype(np.float32)),
             "curr_gripper": _t(g), "action": _t(a)}
    augment = make_device_augment((0.75, 1.25), yaw_range_deg=20.0,
                                  pose_keys=("curr_gripper", "action"))
    out = augment(batch, torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(9)
    rad = np.deg2rad(20.0)
    yaws = (torch.rand((3, 10), generator=gen) * 2 - 1) * rad
    pcds, poses = yaw_rotate_batch(None, batch["pcds"], {"curr_gripper": batch["curr_gripper"],
                                                         "action": batch["action"]},
                                   yaw_range_rad=rad, bounds=torch.tensor(
                                       [[-2.0, -2.0, -2.0], [2.0, 2.0, 2.0]]), yaws=yaws)
    scales = 0.75 + 0.5 * torch.rand(3, generator=gen)
    crop_u = torch.rand((3, 2), generator=gen)
    want = resize_sample({"rgbs": batch["rgbs"], "pcds": pcds}, scales, crop_u)
    for k in ("rgbs", "pcds"):
        assert torch.equal(out[k], want[k]), k
    for k in poses:
        assert torch.equal(out[k], poses[k]), k
    same = make_device_augment((1.0, 1.0))(batch, torch.Generator().manual_seed(9))
    assert all(same[k] is batch[k] for k in batch)


# ------------------------------------------------------------------ dataset
# (name, RLBenchDataset arguments, batch sizes / get_chunk calls)
DATASET_CASES = [
    ("depth_train", dict(wire="depth")),
    ("depth_val", dict(wire="depth", training=False)),
    ("ids_depth", dict(wire="depth", instr_mode="ids")),
    ("ids_pcd", dict(instr_mode="ids")),
    ("no_host_augment", dict(augment_host=False)),
    ("no_host_augment_depth", dict(augment_host=False, wire="depth", instr_mode="ids")),
    ("keypose_pcd", dict(return_low_lvl_trajectory=False, action_dim=8)),
]


def _assert_same_batch(got, want):
    assert list(got) == list(want), (list(got), list(want))
    for key in want:
        if key == "task":
            assert got[key] == want[key]
            continue
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("name,kwargs", DATASET_CASES, ids=[c[0] for c in DATASET_CASES])
def test_batches_and_chunks_equal_jax_bit_for_bit(tree, name, kwargs):
    from act3d_tpu.data.dataset import RLBenchDataset as JaxDataset

    args = _ds_args(tree, max_episode_length=2, **kwargs)
    port, ref = RLBenchDataset(**args), JaxDataset(**args)
    assert port.wire == ref.wire == kwargs.get("wire", "pcd")
    for batch_size in (4, 3):
        _assert_same_batch(port.sample_batch(batch_size), ref.sample_batch(batch_size))
    for episode, chunk in ((0, None), (3, 1), (5, None)):
        _assert_same_batch(port.get_chunk(episode, chunk), ref.get_chunk(episode, chunk))
        _assert_same_batch(port[episode], ref[episode])
    _assert_same_batch(port.get_frame(2, 1), ref.get_frame(2, 1))
    assert len(port) == len(ref) == 4
    if port.instruction_bank is None:
        assert ref.instruction_bank is None
    else:
        np.testing.assert_array_equal(port.instruction_bank, ref.instruction_bank)


def test_instruction_bank_rows_are_the_features(tree):
    feats = RLBenchDataset(**_ds_args(tree)).sample_batch(6)
    ds = RLBenchDataset(**_ds_args(tree, instr_mode="ids"))
    ids = ds.sample_batch(6)
    assert ids["instr_id"].dtype == np.int32 and "instr" not in ids
    assert ds.instruction_bank.shape == (len(TASKS) * 3, 53, 512)
    np.testing.assert_array_equal(ds.instruction_bank[ids["instr_id"]], feats["instr"])
    with pytest.raises(ValueError, match="instr_mode"):
        RLBenchDataset(**_ds_args(tree, instr_mode="tokens"))
    with pytest.raises(ValueError, match="wire"):
        RLBenchDataset(**_ds_args(tree, wire="xyz"))


def test_depth_wire_falls_back_or_raises_on_inconsistent_episodes(tmp_path, caplog):
    root = make_dataset_tree(tmp_path / "data", tasks=TASKS[:1], variations=(0,),
                             episodes_per_variation=2, n_frames=2, n_cam=2, image_size=16)
    files = sorted(root.rglob("*.dat"))
    ep = load_episode(files[1])  # the second episode: 5 cm off its camera model
    for i in range(len(ep[1])):
        ep[1][i][:, 1] += np.float32(0.05)
    save_episode(files[1], ep)
    args = dict(root=root, instructions=make_instructions(TASKS[:1], (0,)),
                taskvar=[(TASKS[0], 0)], cameras=CAMERAS[:2], wire="depth")
    ds = RLBenchDataset(**args)
    assert ds.wire == "depth"  # the first episode passes the init probe
    with pytest.raises(RuntimeError, match="pinhole-consistent"):
        ds.get_frame(1)
    ep = load_episode(files[0])
    ep[1][0][:, 1] += np.float32(0.05)
    save_episode(files[0], ep)
    ds = RLBenchDataset(**args)
    assert ds.wire == "pcd" and "falling back" in caplog.text
    assert "pcds" in ds.sample_batch(2)


# -------------------------------------------------------------------- losses
@pytest.fixture
def few_threads():
    """Two intra-op threads for the model steps: the suite runs beside other
    test processes, where more threads only contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def keypose_setup():
    from act3d_tpu_torch.train.flagship import make_keypose_model
    from act3d_tpu_torch.train.losses import KeyposeLossAndMetrics
    from act3d_tpu_torch.utils.testing import synthetic_keypose_batch

    torch.manual_seed(0)
    model = make_keypose_model(image_size=(128, 128), embedding_dim=12, num_ghost_points=32,
                               num_ghost_points_val=32, num_sampling_level=2, device="cpu")
    batch = {k: np.asarray(v) for k, v in
             synthetic_keypose_batch(batch=2, ncam=1, image_size=(128, 128)).items()}
    # rgb on the uint8 palette, as episode data is
    batch["rgbs"] = (np.rint(batch["rgbs"] * 255) / 255).astype(np.float32)
    return model, KeyposeLossAndMetrics(), batch


def _loss(loss_fn, batch):
    from act3d_tpu_torch.nn.dropout import Generators

    return loss_fn({k: _t(v) for k, v in batch.items()}, Generators.from_seed(5, "cpu"))[0].detach()


def test_keypose_loss_resolves_instr_ids_and_decodes_compact_batches(keypose_setup, few_threads):
    from act3d_tpu_torch.train.flagship import keypose_loss_fn

    model, crit, batch = keypose_setup
    model.train()
    want = float(_loss(keypose_loss_fn(model, crit), batch))
    bank = np.stack([batch["instr"][1], batch["instr"][0]])
    ids = {k: v for k, v in batch.items() if k != "instr"}
    ids["instr_id"] = np.array([1, 0], np.int32)
    got = float(_loss(keypose_loss_fn(model, crit, instr_bank=bank), ids))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError, match="instr_bank"):
        _loss(keypose_loss_fn(model, crit), ids)
    compact = compact_batch(batch)
    assert compact["pcds"].dtype == np.uint16 and compact["rgbs"].dtype == np.uint8
    canonical = {k: v.numpy() for k, v in expand_batch(_port_tree(compact)).items()}
    got = float(_loss(keypose_loss_fn(model, crit), compact))
    np.testing.assert_allclose(got, float(_loss(keypose_loss_fn(model, crit), canonical)),
                               rtol=1e-6)


def test_diffusion_loss_resolves_instr_ids(few_threads):
    from act3d_tpu_torch.train.flagship import diffusion_loss_fn, diffusion_metrics_fn
    from act3d_tpu_torch.utils.testing import synthetic_trajectory_batch

    torch.manual_seed(0)
    from act3d_tpu_torch.train.flagship import make_diffusion_model

    model = make_diffusion_model(image_size=(128, 128), embedding_dim=24,
                                 num_query_cross_attn_layers=4, diffusion_timesteps=5,
                                 device="cpu")
    model.train()
    batch = {k: np.asarray(v) for k, v in synthetic_trajectory_batch(
        batch=2, ncam=1, image_size=(128, 128), traj_len=6).items()}
    bank = batch["instr"][::-1].copy()
    ids = {k: v for k, v in batch.items() if k != "instr"}
    ids["instr_id"] = np.array([1, 0], np.int32)
    want = float(_loss(diffusion_loss_fn(model), batch))
    got = float(_loss(diffusion_loss_fn(model, instr_bank=bank), ids))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    model.eval()
    from act3d_tpu_torch.nn.dropout import Generators

    with torch.no_grad():
        m_ids = diffusion_metrics_fn(model, instr_bank=bank)(_port_tree(ids),
                                                             Generators.from_seed(2, "cpu"))
        m_ref = diffusion_metrics_fn(model)(_port_tree(batch), Generators.from_seed(2, "cpu"))
    np.testing.assert_allclose(float(m_ids["noise_mse"]), float(m_ref["noise_mse"]), rtol=1e-6)


# ---------------------------------------------------------------------- viz
def test_viz_draws_jax_images(tree):
    from act3d_tpu.train import viz as jax_viz

    from act3d_tpu_torch.train import viz

    rng = np.random.default_rng(7)
    pred, gt = rng.normal(size=(2, 12, 7))
    mask = np.zeros(12, bool)
    mask[9:] = True
    img = viz.trajectory_scatter_image(pred, gt, mask)
    assert img.dtype == np.uint8 and img.shape[0] == 3
    np.testing.assert_array_equal(img, jax_viz.trajectory_scatter_image(pred, gt, mask))
    episode = sorted(tree[0].rglob("*.dat"))[0]
    np.testing.assert_array_equal(viz.visualize_episode(episode, max_frames=2),
                                  jax_viz.visualize_episode(episode, max_frames=2))
