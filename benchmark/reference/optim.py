"""Plain AdamW of the reference (Loshchilov and Hutter, 2019; optax.adamw's
arithmetic): betas (0.9, 0.999), eps 1e-8 outside the square root,
decoupled weight decay on matrices (ndim > 1) and none on vectors, the
frozen trunk (every name holding ``backbone``) left out; a parameter that
got no gradient steps on a zero one."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn


class AdamW:
    def __init__(self, model: nn.Module, lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = {n: p for n, p in model.named_parameters() if "backbone" not in n}
        for n, p in model.named_parameters():
            p.requires_grad_("backbone" not in n)
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """One update; returns the gradients it applied."""
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        grads = {}
        for n, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[n] = g
            if p.ndim > 1:
                p.mul_(1.0 - self.lr * self.wd)
            self.m[n] = b1 * self.m[n] + (1.0 - b1) * g
            self.v[n] = b2 * self.v[n] + (1.0 - b2) * g * g
            p.sub_(self.lr * (self.m[n] / c1) / (torch.sqrt(self.v[n] / c2) + self.eps))
            p.grad = None
        return grads
