"""Training-time visualisations, a copy of ``act3d_tpu/train/viz.py``.

The reference's eval-time 3D scatter image logged to TensorBoard
(reference: main_trajectory.py:346-385) and a packaged-episode viewer (the
reference's utils/visualize_keypose_frames.py).  matplotlib (and PIL, for
the PNG) are imported inside the functions: the card's machine need not
have them.
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["trajectory_scatter_image", "visualize_episode"]


def _fig_to_numpy(fig, dpi=120) -> np.ndarray:
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=dpi)
    buf.seek(0)
    import matplotlib.image as mpimg

    img = mpimg.imread(buf)  # (H, W, 4) float in [0, 1]
    return (img[..., :3] * 255).astype(np.uint8)


def trajectory_scatter_image(
    pred: np.ndarray, gt: np.ndarray, mask: np.ndarray, box_size: float = 0.3
) -> np.ndarray:
    """(L, 7) predicted vs ground-truth trajectory -> (3, H, W) uint8 image
    (CHW, TensorBoard layout)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    pred = np.asarray(pred)
    gt = np.asarray(gt)
    valid = ~np.asarray(mask)

    fig = plt.figure(figsize=(8, 8))
    ax = plt.axes(projection="3d")
    ax.scatter3D(*pred[valid][:, :3].T, color="red", label="pred")
    ax.scatter3D(*gt[valid][:, :3].T, color="blue", label="gt")
    center = gt[valid][:, :3].mean(0)
    for setter, c in zip(
        (ax.set_xlim, ax.set_ylim, ax.set_zlim), center
    ):
        setter(c - box_size, c + box_size)
    ax.set_xticklabels([])
    ax.set_yticklabels([])
    ax.set_zticklabels([])
    plt.legend()
    fig.subplots_adjust(left=0, right=1, bottom=0, top=1)
    img = _fig_to_numpy(fig)
    plt.close(fig)
    return img.transpose(2, 0, 1)


def visualize_episode(
    episode_path, out_path: Optional[Path] = None, max_frames: int = 4
) -> np.ndarray:
    """Render a packaged episode's keyframes: per-camera RGB tiles + the
    action trajectory scatter.  Returns (H, W, 3) uint8 (and writes a PNG
    if out_path given)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    from ..data.episode import load_episode

    ep = load_episode(episode_path)
    # slots 0-5; episodes may carry the optional slot-7 camera_params
    # (data/episode.py)
    frame_ids, obs, actions, _, grippers, trajs = ep[:6]
    n = min(len(frame_ids), max_frames)
    ncam = obs[0].shape[0]

    fig, axes = plt.subplots(
        n, ncam + 1, figsize=(3 * (ncam + 1), 3 * n), squeeze=False
    )
    for i in range(n):
        for c in range(ncam):
            rgb = np.asarray(obs[i][c, 0]).transpose(1, 2, 0) / 2 + 0.5
            axes[i][c].imshow(np.clip(rgb, 0, 1))
            axes[i][c].set_axis_off()
            axes[i][c].set_title(f"frame {frame_ids[i]} cam {c}", fontsize=8)
        ax = axes[i][ncam]
        traj = np.asarray(trajs[i]) if i < len(trajs) else None
        if traj is not None:
            ax.plot(traj[:, 0], traj[:, 1], "g.-", markersize=2)
        ax.plot(*np.asarray(grippers[i])[0, :2], "bo", label="gripper")
        ax.plot(*np.asarray(actions[i])[0, :2], "r*", label="keypose")
        ax.legend(fontsize=6)
        ax.set_title("xy path", fontsize=8)
    fig.tight_layout()
    img = _fig_to_numpy(fig)
    plt.close(fig)
    if out_path is not None:
        from PIL import Image

        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(img).save(out_path)
    return img
