"""The port's host data path against the JAX package.

* ``RLBenchDataset.sample_batch`` of the port equals JAX's bit for bit on
  the same fixture tree and seed, batch after batch: keypose training
  (Resize on), keypose validation, and trajectories (dense interpolation
  to 50, Resize on), with camera re-indexing and the per-task episode cap.
* Episode trees written by either package read back identically through
  the other; the native codec's memcpy and blosclz containers match
  JAX's, and the port's decoder reads blosclz itself (no libblosc
  fallback).
* ``parse_config`` of both reference scripts' command lines gives JAX's
  field values; rejected flags raise ``NotImplementedError``.
* ``DeviceFeeder`` keeps batch order, re-raises a batch_fn error and stops
  on ``close()`` on the CPU; a gpu-marked test fills large batches with
  their own step number and checks each one on the card after its
  asynchronous copy (run on the card with
  ``python -m pytest --noconftest tests/test_torch_data.py -m gpu``; it
  imports no JAX).
"""

import ctypes
import pickle
import re
import shlex
from pathlib import Path

import numpy as np
import pytest
import torch

from act3d_tpu_torch.core import config as port_config
from act3d_tpu_torch.data import native as port_native
from act3d_tpu_torch.data.dataset import RLBenchDataset
from act3d_tpu_torch.data.episode import load_episode, save_episode
from act3d_tpu_torch.data.feeder import DeviceFeeder

REPO = Path(__file__).resolve().parent.parent
TASKS = ("pick_and_lift", "close_door")


def _assert_same_tree(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same_tree(a[k], b[k])
    else:
        assert a == b


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    """A tree written by the JAX package's fixture writer: 2 tasks x 2
    variations x 2 episodes of 3 frames, 3 cameras at 32^2."""
    from act3d_tpu.data.fixtures import make_dataset_tree, make_instructions

    root = tmp_path_factory.mktemp("jax_tree")
    make_dataset_tree(root / "data", tasks=TASKS, variations=(0, 1), episodes_per_variation=2,
                      n_frames=3, image_size=32, seed=3)
    return root / "data", make_instructions(tasks=TASKS, variations=(0, 1), n_instr=3, seed=4)


# (name, RLBenchDataset arguments): the CLIs' three uses of the dataset
DATASET_CASES = [
    ("keypose_train", dict(training=True, image_rescale=(0.75, 1.25), action_dim=8,
                           cameras=("left_shoulder", "wrist"))),
    ("keypose_val", dict(training=False, image_rescale=(0.75, 1.25), action_dim=8,
                         max_episodes_per_task=1)),
    ("trajectory_train", dict(training=True, image_rescale=(0.75, 1.25), action_dim=7,
                              return_low_lvl_trajectory=True, dense_interpolation=True,
                              interpolation_length=50)),
]


@pytest.mark.parametrize("name,kwargs", DATASET_CASES, ids=[c[0] for c in DATASET_CASES])
def test_sample_batch_equals_jax_bit_for_bit(jax_tree, name, kwargs):
    from act3d_tpu.data.dataset import RLBenchDataset as JaxDataset

    root, instructions = jax_tree
    args = dict(root=root, instructions=instructions,
                taskvar=[(t, v) for t in TASKS for v in (0, 1)], cache_size=4,
                gripper_loc_bounds=np.array([[-0.5, -0.5, 0.0], [0.9, 0.9, 1.6]]), seed=11,
                **kwargs)
    port, ref = RLBenchDataset(**args), JaxDataset(**args)
    for batch_size in (4, 3, 5):
        got, want = port.sample_batch(batch_size), ref.sample_batch(batch_size)
        assert sorted(got) == sorted(want), (sorted(got), sorted(want))
        for key in want:
            if key == "task":
                assert got[key] == want[key]
                continue
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["rgbs"].shape[:2] == (5, len(args.get("cameras", range(3))))


def test_trees_written_by_either_package_read_back_in_the_other(tmp_path, jax_tree):
    from act3d_tpu.data import episode as jax_episode
    from act3d_tpu.data.fixtures import make_episode

    root, _ = jax_tree
    for path in sorted(root.glob("*/*.dat"))[:3]:
        _assert_same_tree(load_episode(path), jax_episode.load_episode(path))
    from act3d_tpu_torch.data.fixtures import make_episode as port_make_episode

    ep = port_make_episode(n_frames=2, n_cam=2, image_size=16, seed=5)
    _assert_same_tree(ep, make_episode(n_frames=2, n_cam=2, image_size=16, seed=5))
    save_episode(tmp_path / "port.dat", ep)
    _assert_same_tree(jax_episode.load_episode(tmp_path / "port.dat"), ep)
    jax_episode.save_episode(tmp_path / "jax.dat", ep)
    _assert_same_tree(load_episode(tmp_path / "jax.dat"), ep)
    assert (tmp_path / "port.dat").read_bytes() == (tmp_path / "jax.dat").read_bytes()


@pytest.mark.parametrize("payload", ["pickle", "random", "zeros_then_random"])
def test_native_codec_matches_jax(rng, payload):
    from act3d_tpu.data import native as jax_native

    if payload == "pickle":
        data = pickle.dumps({"a": rng.normal(size=(64, 64)).astype(np.float32),
                             "b": list(range(1000))})
    elif payload == "random":
        data = rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    else:
        data = bytes(200_000) + rng.integers(0, 256, 70_001, dtype=np.uint8).tobytes()

    packed = port_native.pack_memcpy(data)
    assert packed == jax_native.pack_memcpy(data)
    assert port_native.decompress(packed) == data == jax_native.decompress(packed)

    compressed = port_native.compress(data)
    assert compressed == jax_native.compress(data)
    assert jax_native.decompress(compressed) == data
    assert port_native.container_info(compressed) == jax_native.container_info(compressed)
    if port_native._system_blosc() is None:
        pytest.skip("no system libblosc: compress wrote the memcpy container")
    assert not port_native.container_info(compressed)[2] & 0x2, "expected blosclz"
    buf = ctypes.create_string_buffer(len(data))
    rc = port_native._lib().blosc_portable_decompress(
        compressed, ctypes.c_int64(len(compressed)), buf, ctypes.c_int64(len(data)))
    assert rc == 0 and buf.raw == data  # decoded by the port's own C++


def test_invalid_container_raises():
    with pytest.raises(ValueError, match="invalid blosc container"):
        port_native.decompress(b"short")


def _script_argv(name):
    """The flags of scripts/<name>, with the positional arguments filled in."""
    text = (REPO / "scripts" / name).read_text()
    body = text[text.index("python -m"):].split("\n\n")[0]
    body = body.replace("\\\n", " ").replace('"$(date +%y%m%d_%H%M%S)"', "run")
    values = {"dataset": "/data/train", "valset": "/data/val",
              "instructions": "/data/instructions.pkl",
              "bounds": "tasks/74_hiveformer_tasks_location_bounds.json",
              "tasks": "pick_and_lift"}
    body = re.sub(r'"?\$(\w+)"?', lambda m: values[m.group(1)], body)
    return shlex.split(body)[3:]  # drop "python -m <module>"


@pytest.mark.parametrize("script,cls", [("train_act3d.sh", "KeyposeConfig"),
                                        ("train_trajectory.sh", "TrajectoryConfig")])
def test_parse_config_of_the_reference_scripts_gives_jax_values(script, cls):
    import dataclasses

    from act3d_tpu.core import config as jax_config

    for argv in (_script_argv(script), []):
        port = port_config.parse_config(getattr(port_config, cls), argv)
        ref = jax_config.parse_config(getattr(jax_config, cls), argv)
        ref_fields = [f.name for f in dataclasses.fields(ref)]
        port_fields = [f.name for f in dataclasses.fields(port)]
        assert [f for f in port_fields if f != "device"] == ref_fields and "device" in port_fields
        for name in ref_fields:
            assert getattr(port, name) == getattr(ref, name), name
        assert port.device == "cuda"
        assert port.log_dir == ref.log_dir and port.image_size_tuple == ref.image_size_tuple
    assert "--batch_size" in _script_argv(script)


def _counting_batches(fail_after=None):
    state = {"i": 0}

    def batch_fn():
        i = state["i"]
        if fail_after is not None and i >= fail_after:
            raise RuntimeError("batch_fn failed")
        state["i"] += 1
        return {"x": np.full((4, 3), i, np.float32), "flag": np.array([i % 2 == 0]),
                "task": [f"t{i}"]}

    return batch_fn


def test_device_feeder_keeps_order_and_closes_on_the_cpu():
    feeder = DeviceFeeder(_counting_batches(), device="cpu")
    for i in range(8):
        batch = next(feeder)
        assert isinstance(batch["x"], torch.Tensor) and batch["x"].device.type == "cpu"
        assert torch.equal(batch["x"], torch.full((4, 3), float(i)))
        assert batch["flag"].dtype == torch.bool and bool(batch["flag"][0]) == (i % 2 == 0)
        assert batch["task"] == [f"t{i}"]
    feeder.close()
    assert not feeder._thread.is_alive()


def test_device_feeder_raises_the_batch_fn_error():
    feeder = DeviceFeeder(_counting_batches(fail_after=2), device="cpu")
    next(feeder), next(feeder)
    with pytest.raises(RuntimeError, match="batch_fn failed"):
        next(feeder)
    feeder.close()
    assert not feeder._thread.is_alive()


@pytest.mark.gpu
def test_device_feeder_batches_land_intact_on_the_card():
    """64 MB batches filled with their step number, copied asynchronously
    on the side stream while the main stream is busy; each batch must
    arrive whole and in order, and its memory must not be reused while the
    main stream still reads it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 16 * 2**20
    count = iter(range(10**6))

    def batch_fn():
        i = next(count)
        return {"x": np.full(n, i, np.float32), "task": [i]}

    feeder = DeviceFeeder(batch_fn, device="cuda")
    busy = torch.randn(2048, 2048, device="cuda")
    sums = []
    for i in range(12):
        batch = next(feeder)
        for _ in range(4):  # keep the main stream busy while later copies land
            busy = busy @ busy
            busy = busy / busy.norm()
        assert batch["task"] == [i]
        sums.append((batch["x"] - i).abs().max())
        del batch
    feeder.close()
    assert torch.stack(sums).max().item() == 0.0
    assert not feeder._thread.is_alive()
