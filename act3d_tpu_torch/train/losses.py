"""Keypose loss and metrics (PyTorch).

Counterpart of ``act3d_tpu/train/losses.py``: ``soft_cross_entropy``,
:class:`KeyposeLossAndMetrics` (soft-CE over the ghost-point pyramid +
quaternion MSE + gripper MSE, reference main_keypose.py:295-482), the
host-side :func:`split_metrics_by_task` and
:class:`TrajectoryCriterion`'s metrics of a sampled trajectory.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["KeyposeLossAndMetrics", "TrajectoryCriterion", "soft_cross_entropy",
           "split_metrics_by_task"]


def soft_cross_entropy(logits: torch.Tensor, soft_labels: torch.Tensor,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Cross-entropy with probability targets: mean over the batch of
    -sum(labels * log_softmax(logits))."""
    if label_smoothing > 0.0:
        n = logits.shape[-1]
        soft_labels = soft_labels * (1.0 - label_smoothing) + label_smoothing / n
    return -torch.mean(torch.sum(soft_labels * F.log_softmax(logits, dim=-1), dim=-1))


def _l2(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(x), dim=dim))


@dataclasses.dataclass(frozen=True)
class KeyposeLossAndMetrics:
    """position CE over the ghost pyramid + rotation MSE + gripper MSE."""

    position_loss: str = "ce"  # "ce" | "mse" | "ce+mse"
    rotation_parametrization: str = "quat_from_query"
    compute_loss_at_all_layers: bool = False
    ground_truth_gaussian_spread: float = 0.01
    label_smoothing: float = 0.0
    position_loss_coeff: float = 1.0
    position_offset_loss_coeff: float = 10000.0
    rotation_loss_coeff: float = 10.0
    gripper_loss_coeff: float = 1.0
    symmetric_rotation_loss: bool = False

    def compute_loss(self, pred: Dict, gt_action: torch.Tensor) -> Dict[str, torch.Tensor]:
        """gt_action: (B, 8) = pos(3) + quat xyzw(4) + gripper(1)."""
        losses: Dict[str, torch.Tensor] = {}
        gt_position = gt_action[:, :3]

        if self.position_loss in ("ce", "ce+mse"):
            num_levels = len(pred["ghost_pcd_masks_pyramid"])
            for i, masks_i in enumerate(pred["ghost_pcd_masks_pyramid"]):
                l2_i = _l2(pred["ghost_pcd_pyramid"][i] - gt_position[:, None, :], -1)
                # labels carry no gradient (stop_gradient in JAX)
                label_i = torch.softmax(
                    -l2_i / self.ground_truth_gaussian_spread, dim=-1).detach()
                # default: only the last attention layer's mask is supervised
                layers = masks_i if self.compute_loss_at_all_layers else masks_i[-1:]
                ce = sum(soft_cross_entropy(m, label_i, self.label_smoothing) for m in layers)
                losses[f"position_ce_level{i}"] = ce * self.position_loss_coeff / num_levels
            if pred.get("fine_ghost_pcd_offsets") is not None:
                pred_with_offset = pred["ghost_pcd_pyramid"][-1] + pred["fine_ghost_pcd_offsets"]
                losses["position_offset"] = (
                    torch.mean(torch.square(pred_with_offset - gt_position[:, None, :]))
                    * self.position_offset_loss_coeff * self.position_loss_coeff)
        if self.position_loss in ("mse", "ce+mse"):
            losses["position_mse"] = (torch.mean(torch.square(pred["position"] - gt_position))
                                      * self.position_loss_coeff)

        gt_quat = gt_action[:, 3:7]
        if "quat" in self.rotation_parametrization:
            if self.symmetric_rotation_loss:
                l_pos = torch.mean(torch.square(pred["rotation"] - gt_quat), dim=1)
                l_neg = torch.mean(torch.square(pred["rotation"] + gt_quat), dim=1)
                rotation = torch.mean(torch.minimum(l_pos, l_neg))
            else:
                rotation = torch.mean(torch.square(pred["rotation"] - gt_quat))
            losses["rotation"] = rotation * self.rotation_loss_coeff

        losses["gripper"] = (torch.mean(torch.square(pred["gripper"] - gt_action[:, 7:8]))
                             * self.gripper_loss_coeff)
        return losses

    def compute_metrics(self, pred: Dict, gt_action: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-sample (B,) metrics; aggregate or split by task on the host."""
        metrics: Dict[str, torch.Tensor] = {}
        gt_position = gt_action[:, :3]
        final_pos_l2 = _l2(pred["position"] - gt_position, 1)
        metrics["pos_l2_final"] = final_pos_l2
        metrics["pos_l2_final<0.01"] = (final_pos_l2 < 0.01).float()
        for i, pos_i in enumerate(pred["position_pyramid"]):
            metrics[f"pos_l2_level{i}"] = _l2(pos_i - gt_position, 1)

        pred_gripper = pred["gripper"][:, 0] > 0.5
        true_gripper = gt_action[:, 7] > 0.5
        metrics["gripper"] = (pred_gripper == true_gripper).float()

        gt_quat = gt_action[:, 3:7]
        if "quat" in self.rotation_parametrization:
            l1 = torch.sum(torch.abs(pred["rotation"] - gt_quat), dim=1)
            if self.symmetric_rotation_loss:
                l1 = torch.minimum(l1, torch.sum(torch.abs(pred["rotation"] + gt_quat), dim=1))
            metrics["rot_l1"] = l1
            metrics["rot_l1<0.05"] = (l1 < 0.05).float()
            metrics["rot_l1<0.025"] = (l1 < 0.025).float()
        return metrics


def split_metrics_by_task(metrics: Dict[str, object], tasks: List[str]) -> Dict[str, float]:
    """Host-side per-task breakdown of per-sample metric arrays ('{task}/metric'
    and 'mean/metric' keys, reference main_keypose.py:449-452, 476-480).
    Arrays that are not (len(tasks),) pass through under 'mean/' keys."""
    out: Dict[str, float] = {}
    task_arr = np.asarray(tasks)
    for name, values in metrics.items():
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu()
        v = np.asarray(values)
        out[f"mean/{name}"] = float(np.mean(v))
        if v.ndim == 0 or v.shape[0] != len(tasks):
            continue
        for task in np.unique(task_arr):
            out[f"{task}/{name}"] = float(v[task_arr == task].mean())
    return out


class TrajectoryCriterion:
    """Metrics of a sampled trajectory (reference main_trajectory.py:295-343).
    The training loss itself is ``DiffusionPlanner.forward``."""

    @staticmethod
    def compute_metrics(pred: torch.Tensor, gt: torch.Tensor) -> Dict[str, torch.Tensor]:
        """pred / gt: (B, L, 7).  Scalar metrics under '<name>' and
        per-sample (B,) ones under 'per_sample/<name>'."""
        pos_l2 = _l2(pred[..., :3] - gt[..., :3], -1)
        quat_l1 = torch.minimum(torch.sum(torch.abs(pred[..., 3:7] - gt[..., 3:7]), -1),
                                torch.sum(torch.abs(pred[..., 3:7] + gt[..., 3:7]), -1))
        out = {
            "traj_action_mse": torch.mean(torch.square(pred - gt)),
            "traj_pos_l2": torch.mean(pos_l2),
            "traj_pos_acc_001": torch.mean((pos_l2 < 0.01).float()),
            "traj_rot_l1": torch.mean(quat_l1),
            "traj_rot_acc_0025": torch.mean((quat_l1 < 0.025).float()),
            "per_sample/traj_pos_l2": torch.mean(pos_l2, dim=-1),
            "per_sample/traj_rot_l1": torch.mean(quat_l1, dim=-1),
        }
        # final-keypose metrics (useful when not goal-conditioned)
        kp_pos_l2 = _l2(pred[:, -1, :3] - gt[:, -1, :3], -1)
        kp_l1 = torch.minimum(torch.sum(torch.abs(pred[:, -1, 3:7] - gt[:, -1, 3:7]), -1),
                              torch.sum(torch.abs(pred[:, -1, 3:7] + gt[:, -1, 3:7]), -1))
        out.update({
            "pos_l2": torch.mean(kp_pos_l2),
            "pos_acc_001": torch.mean((kp_pos_l2 < 0.01).float()),
            "rot_l1": torch.mean(kp_l1),
            "rot_acc_0025": torch.mean((kp_l1 < 0.025).float()),
        })
        return out
