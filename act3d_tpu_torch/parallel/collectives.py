"""Metric aggregation across ranks.

Counterpart of ``act3d_tpu/parallel/collectives.py`` (the reference's
pickled NCCL all_gather of eval-metric dicts, engine.py:247-307) over
``torch.distributed.all_gather_object`` on the host (gloo) group of
``mesh.init_distributed``.  Every function is the identity on one process,
as the reference's world_size == 1 path (engine.py:256-258).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch.distributed as dist

from .mesh import host_group, world_size

__all__ = ["all_gather_metrics", "any_rank", "mean_over_ranks",
           "synchronize_between_processes"]


def _all_gather(obj: Any) -> List[Any]:
    if world_size() == 1:
        return [obj]
    gathered: List[Any] = [None] * world_size()
    dist.all_gather_object(gathered, obj, group=host_group())
    return gathered


def all_gather_metrics(metrics: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every rank's host-side metric dict, in rank order."""
    return _all_gather(metrics)


def synchronize_between_processes(values: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Concatenate per-process metric arrays in rank order (reference
    engine.py:232-244): per-sample arrays of the ranks' rows become the
    arrays of the global batch."""
    gathered = all_gather_metrics(values)
    return {k: np.concatenate([np.atleast_1d(np.asarray(g[k])) for g in gathered])
            for k in gathered[0]}


def mean_over_ranks(value: float) -> float:
    """The mean of a host float over the ranks: the global value of a
    per-rank mean over equal row counts."""
    return float(np.mean(_all_gather(float(value))))


def any_rank(flag: bool) -> bool:
    """True on every rank when it is True on any (a stop request)."""
    return any(_all_gather(bool(flag)))
