"""Optimizer construction.

Counterpart of ``act3d_tpu/train/optim.py``: AdamW with two parameter
groups, weight decay for matrices (``ndim > 1``) and none for biases and
LayerNorm parameters (``ndim <= 1``), and the frozen backbone, here
``requires_grad=False`` and left out of the optimizer.  torch's AdamW with
betas (0.9, 0.999), eps 1e-8 and decoupled decay is optax.adamw's
arithmetic.  JAX's flat-vector layout (``flatten=True``) is a TPU dispatch
trick and is not carried over.

Under data parallelism the backbone is frozen (:func:`freeze_backbone`)
before the model is wrapped, and the groups are formed from the
unwrapped module's parameter names, which FSDP2 keeps (its parameters
become DTensors of the same names and global shapes).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from ..parallel.mesh import full_optimizer_state, load_full_optimizer_state

__all__ = ["GradientAccumulator", "freeze_backbone", "make_optimizer"]


def freeze_backbone(model: nn.Module) -> nn.Module:
    """``requires_grad_(False)`` on every param whose name contains
    ``backbone``."""
    for name, param in model.named_parameters():
        if "backbone" in name:
            param.requires_grad_(False)
    return model


def make_optimizer(model: nn.Module, lr: float = 1e-4,
                   weight_decay: float = 5e-4) -> torch.optim.AdamW:
    """AdamW over the trainable params of ``model`` (not a DDP wrapper: its
    names carry a ``module.`` prefix); freezes every param whose name
    contains ``backbone``."""
    decay: List[nn.Parameter] = []
    no_decay: List[nn.Parameter] = []
    for name, param in freeze_backbone(model).named_parameters():
        if "backbone" in name:
            continue
        if param.ndim > 1:
            decay.append(param)
        else:
            no_decay.append(param)
    return torch.optim.AdamW(
        [{"params": decay, "weight_decay": weight_decay},
         {"params": no_decay, "weight_decay": 0.0}],
        lr=lr, betas=(0.9, 0.999), eps=1e-8,
    )


class GradientAccumulator:
    """optax.MultiSteps: the gradients of ``every_k`` micro-batches are
    averaged before one optimizer step.  Autograd sums them in ``.grad``;
    :meth:`step` divides by k on the k-th call and steps.  A param that got
    no gradient (an FPN level the model does not read) gets a zero one, as
    in optax's full gradient tree, so AdamW still decays it.  After the
    step the gradients are zeroed in place, not freed: a training step
    replayed from a CUDA graph (``train/step_graph.py``) adds into them
    where they are."""

    def __init__(self, optimizer: torch.optim.Optimizer, every_k: int = 1):
        if every_k < 1:
            raise ValueError(f"every_k={every_k}")
        self.optimizer = optimizer
        self.every_k = every_k
        self.count = 0

    def step(self) -> bool:
        """Call after each backward; True when the optimizer stepped."""
        self.count += 1
        if self.count < self.every_k:
            return False
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                elif self.every_k > 1:
                    p.grad.div_(self.every_k)
        self.optimizer.step()
        # a few multi-tensor launches; zero_grad(set_to_none=False) zeroes
        # each gradient with a launch of its own
        torch._foreach_zero_([p.grad for group in self.optimizer.param_groups
                              for p in group["params"] if p.grad is not None])
        self.count = 0
        return True

    def state_dict(self):
        """In the one-device layout whatever the mesh (every rank calls it:
        sharded moments are gathered)."""
        return {"optimizer": full_optimizer_state(self.optimizer), "count": self.count}

    def load_state_dict(self, state):
        load_full_optimizer_state(self.optimizer, state["optimizer"])
        self.count = state["count"]
