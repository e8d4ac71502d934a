"""Task suites, instruction loading, workspace bounds and vendored assets.

A copy of ``act3d_tpu/utils/registry.py`` (reference
utils/utils_without_rlbench.py:34-121 and the tasks/*.csv suite lists).
The task suites are facts of the RLBench benchmark.  Workspace-bound JSONs
({task: [[min_xyz], [max_xyz]]}), episodes.json and the task CSVs are data
files vendored under the repository's ``assets/``; a bare file name
resolves there.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.nn as nn

__all__ = ["PERACT_18_TASKS", "HIVEFORMER_74_TASKS", "AUTOLAMBDA_10_TASKS", "ALL_TASKS",
           "TASK_TO_ID", "asset_path", "count_parameters", "get_gripper_loc_bounds",
           "get_max_episode_length", "load_episodes", "load_instructions", "load_task_csv"]

ASSETS_DIR = Path(__file__).resolve().parents[2] / "assets"

PERACT_18_TASKS = (
    "turn_tap", "open_drawer", "push_buttons", "sweep_to_dustpan_of_size",
    "slide_block_to_color_target", "insert_onto_square_peg", "meat_off_grill",
    "place_shape_in_shape_sorter", "place_wine_at_rack_location",
    "put_groceries_in_cupboard", "put_money_in_safe", "close_jar",
    "reach_and_drag", "light_bulb_in", "stack_cups", "place_cups",
    "put_item_in_drawer", "stack_blocks",
)

HIVEFORMER_74_TASKS = (
    "reach_target", "close_drawer", "close_fridge", "close_microwave",
    "lamp_off", "press_switch", "push_button", "slide_block_to_target",
    "take_usb_out_of_computer", "turn_tap", "unplug_charger", "close_door",
    "lamp_on", "lift_numbered_block", "open_box", "open_drawer",
    "open_fridge", "open_grill", "open_microwave", "open_wine_bottle",
    "pick_up_cup", "play_jenga", "take_lid_off_saucepan",
    "take_umbrella_out_of_umbrella_stand", "toilet_seat_up", "turn_oven_on",
    "basketball_in_hoop", "beat_the_buzz", "change_clock", "close_grill",
    "close_laptop_lid", "hang_frame_on_hanger", "open_door", "open_window",
    "pick_and_lift", "pick_and_lift_small", "put_knife_on_chopping_board",
    "put_rubbish_in_bin", "put_umbrella_in_umbrella_stand",
    "scoop_with_spatula", "take_frame_off_hanger", "take_money_out_safe",
    "take_toilet_roll_off_stand", "toilet_seat_down", "close_box",
    "insert_onto_square_peg", "insert_usb_in_computer", "meat_off_grill",
    "meat_on_grill", "move_hanger", "open_oven", "phone_on_base",
    "place_hanger_on_rack", "place_shape_in_shape_sorter",
    "plug_charger_in_power_supply", "put_books_on_bookshelf",
    "put_money_in_safe", "sweep_to_dustpan",
    "take_plate_off_colored_dish_rack", "water_plants", "push_buttons",
    "reach_and_drag", "screw_nail", "setup_checkers", "stack_wine", "tower3",
    "wipe_desk", "straighten_rope", "change_channel", "tv_on",
    "slide_cabinet_open_and_place_cups", "stack_cups",
    "take_shoes_out_of_box", "stack_blocks",
)

AUTOLAMBDA_10_TASKS = (
    "pick_and_lift", "pick_up_cup", "push_button",
    "put_knife_on_chopping_board", "put_money_in_safe", "reach_target",
    "slide_block_to_target", "stack_wine", "take_money_out_safe",
    "take_umbrella_out_of_umbrella_stand",
)

# the 82-task union in the reference's canonical (alphabetical) order
# (reference utils/utils_without_rlbench.py:100-119)
ALL_TASKS = tuple(sorted(set(HIVEFORMER_74_TASKS) | set(PERACT_18_TASKS)))
TASK_TO_ID = {task: i for i, task in enumerate(ALL_TASKS)}



def load_instructions(instructions: Optional[Path], tasks: Optional[Sequence[str]] = None,
                      variations: Optional[Sequence[int]] = None):
    """Filtered unpickle of instructions.pkl: task -> var -> (n, 53, 512)
    numpy (torch tensors in legacy pickles are converted)."""
    if instructions is None:
        return None
    with open(instructions, "rb") as fid:
        data = pickle.load(fid)
    if tasks is not None:
        data = {t: v for t, v in data.items() if t in tasks}
    if variations is not None:
        data = {t: {var: ins for var, ins in v.items() if var in variations}
                for t, v in data.items()}

    def to_np(x):
        if type(x).__module__.startswith("torch"):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    return {t: {var: to_np(ins) for var, ins in v.items()} for t, v in data.items()}


def asset_path(name: str) -> Path:
    """A vendored run artifact by bare name: ``assets/``, ``assets/tasks/``
    or ``assets/data_preprocessing/``."""
    for candidate in (ASSETS_DIR / name, ASSETS_DIR / "tasks" / name,
                      ASSETS_DIR / "data_preprocessing" / name):
        if candidate.exists():
            return candidate
    raise FileNotFoundError(f"no vendored asset named {name!r} under {ASSETS_DIR}")


def _resolve(path) -> Path:
    """A real path, or a vendored asset found by name."""
    p = Path(path)
    if p.exists():
        return p
    if len(p.parts) == 1:
        return asset_path(p.name)
    return p


def load_task_csv(path) -> Tuple[str, ...]:
    """Task list from a reference-layout CSV (comma-separated rows,
    reference tasks/*.csv)."""
    text = _resolve(path).read_text().strip()
    return tuple(t for line in text.splitlines() for t in line.split(",") if t)


def get_gripper_loc_bounds(path: str, buffer: float = 0.0,
                           task: Optional[str] = None) -> np.ndarray:
    """(2, 3) [min, max] workspace bounds for one task or the union of all
    (reference utils_without_rlbench.py:54-68)."""
    with open(_resolve(path)) as f:
        bounds = json.load(f)
    if task is not None and task in bounds:
        lo = np.array(bounds[task][0]) - buffer
        hi = np.array(bounds[task][1]) + buffer
    else:
        lo = np.min(np.stack([b[0] for b in bounds.values()]), axis=0) - buffer
        hi = np.max(np.stack([b[1] for b in bounds.values()]), axis=0) + buffer
    print("Gripper workspace size:", hi - lo)
    return np.stack([lo, hi])


def load_episodes(path="episodes.json") -> Dict:
    """episodes.json: {'max_episode_length': {task: int}, 'broken': [...],
    'variable_length': [...]} (reference data_preprocessing/episodes.json);
    the vendored copy by default."""
    with open(_resolve(path)) as fid:
        return json.load(fid)


def get_max_episode_length(episodes: Dict, tasks: Tuple[str, ...],
                           variations: Tuple[int, ...]) -> int:
    """The longest episode of ``tasks`` (``variations`` is unused, as in
    the reference)."""
    return max(episodes["max_episode_length"][t] for t in tasks)


def count_parameters(module: nn.Module) -> int:
    """Number of parameter elements of a module."""
    return sum(p.numel() for p in module.parameters())
