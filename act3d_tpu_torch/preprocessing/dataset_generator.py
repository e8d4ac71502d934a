"""Raw demonstration collection from live RLBench simulation.

Counterpart of ``act3d_tpu/preprocessing/dataset_generator.py`` (reference
data_preprocessing/dataset_generator.py): runs
headless CoppeliaSim per worker process, collects live demos for every
task variation with retry-on-failure, and saves per-step observations
(RGB/depth/mask per camera as PNG + low_dim_obs.pkl + variation number)
in RLBench's stored-demo layout so they can be replayed by
``preprocessing.data_gen`` and the evaluator.

Simulator-bound (``run_worker`` imports RLBench and PyRep, the PNG writer
PIL, each inside the function); the multiprocessing fan-out over tasks
mirrors the reference harness (dataset_generator.py:475-507).  The save /
verify / retry functions take duck-typed demos and envs.

Run (on the host, with the simulator):
  python -m act3d_tpu_torch.preprocessing.dataset_generator \
      --save_path /path/raw --tasks pick_and_lift \
      --episodes_per_task 100 --processes 1
"""

from __future__ import annotations

import argparse
import pickle
import shutil
from multiprocessing import Manager, Process
from pathlib import Path

import numpy as np

MAX_ATTEMPTS = 100


def _save_png(path: Path, array: np.ndarray):
    from PIL import Image

    Image.fromarray(array).save(path)


def _save_depth_png(depth: np.ndarray, path: Path):
    """float depth in [0,1] -> 24-bit RGB PNG, RLBench's stored-demo
    encoding (rlbench.backend.utils.float_array_to_rgb_image with
    DEPTH_SCALE=2**24-1); uses RLBench's own codec when available."""
    try:
        from rlbench.backend import utils as rlb_utils
        from rlbench.backend.const import DEPTH_SCALE

        rlb_utils.float_array_to_rgb_image(
            depth, scale_factor=DEPTH_SCALE
        ).save(str(path))
        return
    except ImportError:
        pass
    scaled = (np.clip(depth, 0.0, 1.0) * (2**24 - 1)).astype(np.uint32)
    rgb = np.stack(
        [(scaled >> 16) & 255, (scaled >> 8) & 255, scaled & 255], axis=-1
    ).astype(np.uint8)
    _save_png(path, rgb)


def save_demo(demo, example_path: Path, cameras, variation: int | None = None):
    """Write one demo in RLBench stored-episode layout
    (reference dataset_generator.py:146-267), including the variation
    number file and the demo's captured numpy random seed state (when the
    demo was collected via :func:`collect_seeded_demo`)."""
    example_path.mkdir(parents=True, exist_ok=True)
    for cam in cameras:
        for modality in ("rgb", "depth", "mask"):
            (example_path / f"{cam}_{modality}").mkdir(exist_ok=True)

    for i, obs in enumerate(demo):
        for cam in cameras:
            rgb = getattr(obs, f"{cam}_rgb", None)
            if rgb is not None:
                _save_png(example_path / f"{cam}_rgb" / f"{i}.png", rgb)
                setattr(obs, f"{cam}_rgb", None)
            depth = getattr(obs, f"{cam}_depth", None)
            if depth is not None:
                _save_depth_png(
                    depth, example_path / f"{cam}_depth" / f"{i}.png"
                )
                setattr(obs, f"{cam}_depth", None)
            mask = getattr(obs, f"{cam}_mask", None)
            if mask is not None:
                _save_png(
                    example_path / f"{cam}_mask" / f"{i}.png",
                    mask.astype(np.uint8),
                )
                setattr(obs, f"{cam}_mask", None)

    with open(example_path / "low_dim_obs.pkl", "wb") as f:
        pickle.dump(demo, f)
    if variation is not None:
        with open(example_path / "variation_number.pkl", "wb") as f:
            pickle.dump(variation, f)


def collect_seeded_demo(
    task_env,
    random_seed_state=None,
    max_attempts: int = MAX_ATTEMPTS,
    callable_each_step=None,
):
    """One live demo with deterministic numpy seed-state capture/replay.

    Mirrors the reference's ``CustomizedTaskEnvironment._get_live_demos``
    (dataset_generator.py:93-120): before every attempt the numpy RNG state
    is either captured (fresh collection) or restored (replay of a stored
    ``demo.random_seed``), the env is reset, and the captured state is
    attached to the returned demo — so any stored demo can be re-generated
    bit-identically by passing its ``random_seed`` back in.
    """
    last_error = None
    for _ in range(max_attempts):
        if random_seed_state is None:
            seed = np.random.get_state()
        else:
            seed = random_seed_state
            np.random.set_state(seed)
        task_env.reset()
        try:
            scene = getattr(task_env, "_scene", None)
            if scene is not None:
                demo = scene.get_demo(callable_each_step=callable_each_step)
            else:  # duck-typed envs (tests)
                (demo,) = task_env.get_demos(amount=1, live_demos=True)
            demo.random_seed = seed
            return demo
        except Exception as e:  # sim demo collection is inherently flaky
            last_error = e
    raise RuntimeError(
        f"could not collect a demo after {max_attempts} attempts: {last_error}"
    )


def verify_demo_and_rgbs(demo, example_path: Path, cameras):
    """Assert the saved PNG count per camera/modality matches the demo
    length (reference dataset_generator.py:270-327, generalised over the
    camera list instead of hardcoding all five)."""
    example_path = Path(example_path)
    n = len(demo)
    for cam in cameras:
        for modality in ("rgb", "depth", "mask"):
            folder = example_path / f"{cam}_{modality}"
            count = len(list(folder.glob("*.png"))) if folder.exists() else 0
            if count != n:
                raise AssertionError(
                    f"{folder}: {count} PNGs != demo length {n}"
                )
    if not (example_path / "low_dim_obs.pkl").exists():
        raise AssertionError(f"{example_path}: missing low_dim_obs.pkl")


def collect_and_save_episode(
    task_env,
    episode_path: Path,
    cameras,
    variation: int,
    max_attempts: int = MAX_ATTEMPTS,
):
    """collect -> save -> verify, cleaning up the partial episode directory
    and retrying on any failure (reference dataset_generator.py:427-464)."""
    last_error = None
    for _ in range(max_attempts):
        try:
            demo = collect_seeded_demo(task_env, max_attempts=1)
            save_demo(demo, episode_path, cameras, variation=variation)
            verify_demo_and_rgbs(demo, episode_path, cameras)
            return demo
        except Exception as e:
            last_error = e
            if episode_path.exists():
                shutil.rmtree(episode_path)
    raise RuntimeError(
        f"episode {episode_path} failed after {max_attempts} attempts: "
        f"{last_error}"
    )


def run_worker(proc_id, lock, task_index, variation_count, args):
    """One sim process collecting demos (dataset_generator.py:330-472)."""
    from pyrep.const import RenderMode  # noqa: F401
    from rlbench.action_modes.action_mode import MoveArmThenGripper
    from rlbench.action_modes.arm_action_modes import JointVelocity
    from rlbench.action_modes.gripper_action_modes import Discrete
    from rlbench.backend.const import EPISODES_FOLDER, VARIATIONS_FOLDER
    from rlbench.environment import Environment

    from ..eval.rlbench_env import RLBenchEnv, task_file_to_task_class

    obs_config = RLBenchEnv.create_obs_config(
        tuple(int(x) for x in args.image_size.split(",")),
        True, True, True, tuple(args.cameras),
    )
    env = Environment(
        MoveArmThenGripper(JointVelocity(), Discrete()),
        "", obs_config, headless=True,
    )
    env.launch()

    tasks = args.tasks
    while True:
        with lock:
            if task_index.value >= len(tasks):
                break
            my_task = tasks[task_index.value]
            task_index.value += 1

        task = env.get_task(task_file_to_task_class(my_task))
        n_variations = task.variation_count()
        if args.variations > 0:
            n_variations = min(n_variations, args.variations)

        for variation in range(n_variations):
            task.set_variation(variation)
            descriptions, _ = task.reset()
            var_path = (
                Path(args.save_path) / my_task
                / (VARIATIONS_FOLDER % variation)
            )
            var_path.mkdir(parents=True, exist_ok=True)
            with open(var_path / "variation_descriptions.pkl", "wb") as f:
                pickle.dump(descriptions, f)
            episodes_path = var_path / EPISODES_FOLDER
            for ex_idx in range(args.episodes_per_task):
                try:
                    demo = collect_and_save_episode(
                        task,
                        episodes_path / f"episode{ex_idx}",
                        args.cameras,
                        variation,
                    )
                except RuntimeError as e:
                    print(f"[worker {proc_id}] {e} — skipping variation")
                    break
                print(
                    f"[worker {proc_id}] saved {my_task} var {variation} "
                    f"ep {ex_idx} ({len(demo)} steps)"
                )
    env.shutdown()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--save_path", required=True)
    p.add_argument("--tasks", nargs="+", required=True)
    p.add_argument("--episodes_per_task", type=int, default=100)
    p.add_argument("--variations", type=int, default=-1)
    p.add_argument("--image_size", default="256,256")
    p.add_argument(
        "--cameras", nargs="*",
        default=["left_shoulder", "right_shoulder", "wrist", "front"],
    )
    p.add_argument("--processes", type=int, default=1)
    args = p.parse_args(argv)

    manager = Manager()
    lock = manager.Lock()
    task_index = manager.Value("i", 0)

    procs = [
        Process(target=run_worker, args=(i, lock, task_index, None, args))
        for i in range(args.processes)
    ]
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join()


if __name__ == "__main__":
    main()
