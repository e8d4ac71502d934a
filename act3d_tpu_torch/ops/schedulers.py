"""DDPM noise schedules for the trajectory sampler (PyTorch).

Counterpart of ``act3d_tpu/ops/schedulers.py``: ``scaled_linear`` for
positions and ``squaredcos_cap_v2`` for rotations, both predicting the
clean sample, with diffusers' defaults (beta 1e-4..0.02, clip_sample=True
at range 1.0, variance_type="fixed_small").  Tables are derived in float64
and cast to float32 only at the end: the 1/(1 - alphas_cumprod) division
near t=0 amplifies float32 cumprod error.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

__all__ = ["DDPMSchedule", "make_ddpm_schedule"]

CLIP_SAMPLE_RANGE = 1.0


def _betas(schedule: str, num_timesteps: int) -> np.ndarray:
    beta_start, beta_end = 1e-4, 0.02
    if schedule == "scaled_linear":
        return (
            np.linspace(beta_start**0.5, beta_end**0.5, num_timesteps,
                        dtype=np.float64)
            ** 2
        )
    if schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        return np.asarray(
            [
                min(1.0 - alpha_bar((i + 1) / num_timesteps)
                    / alpha_bar(i / num_timesteps), 0.999)
                for i in range(num_timesteps)
            ],
            dtype=np.float64,
        )
    raise ValueError(f"unknown beta schedule {schedule!r}")


class DDPMSchedule(nn.Module):
    """Coefficient tables, each (T,) float32, as non-persistent buffers so
    they follow the owning module's device and stay out of its state_dict.

    x_{t-1} = posterior_x0_coeff[t] * x0_hat + posterior_xt_coeff[t] * x_t
              + sqrt(posterior_variance[t]) * eps

    ``step_coeffs`` (T, 3) holds those three factors of each t side by
    side, so a step indexed by a device tensor gathers them in one kernel.
    """

    _TABLES = ("betas", "alphas_cumprod", "sqrt_alphas_cumprod",
               "sqrt_one_minus_alphas_cumprod", "posterior_x0_coeff",
               "posterior_xt_coeff", "posterior_variance")

    def __init__(self, tables):
        super().__init__()
        for name in self._TABLES:
            self.register_buffer(name, torch.as_tensor(np.asarray(tables[name], np.float32)),
                                 persistent=False)
        self.register_buffer("step_coeffs", torch.stack(
            [self.posterior_x0_coeff, self.posterior_xt_coeff,
             torch.sqrt(self.posterior_variance)], dim=1), persistent=False)
        self.num_timesteps = len(tables["betas"])

    def add_noise(self, x0, noise, timesteps):
        """Diffuse clean samples to step t; timesteps (B,) int."""
        shape = timesteps.shape + (1,) * (x0.ndim - timesteps.ndim)
        a = self.sqrt_alphas_cumprod[timesteps].reshape(shape)
        b = self.sqrt_one_minus_alphas_cumprod[timesteps].reshape(shape)
        return a * x0 + b * noise

    def step(self, model_output, timestep, sample, noise):
        """One reverse step t -> t-1 for ``prediction_type="sample"``.

        ``timestep`` is an int, or a one-element int64 tensor on the tables'
        device (a CUDA graph's step, which reads t without a host round
        trip: indexing by a 0-d tensor would read it back); both give the
        same numbers.  ``noise`` is standard normal of the sample's shape, or
        None at t = 0, which takes no noise term.
        """
        x0 = torch.clamp(model_output, -CLIP_SAMPLE_RANGE, CLIP_SAMPLE_RANGE)
        coeffs = self.step_coeffs[timestep].reshape(3)
        prev = coeffs[0] * x0 + coeffs[1] * sample
        if noise is not None:
            prev = prev + coeffs[2] * noise
        return prev


def make_ddpm_schedule(
    beta_schedule: str,
    num_timesteps: int = 100,
    device="cpu",
) -> DDPMSchedule:
    """Tables derived in float64, then cast to float32."""
    betas = _betas(beta_schedule, num_timesteps)
    alphas_cumprod = np.cumprod(1.0 - betas)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
    current_alpha = alphas_cumprod / alphas_cumprod_prev
    current_beta = 1.0 - current_alpha
    beta_prod = 1.0 - alphas_cumprod
    posterior_x0_coeff = np.sqrt(alphas_cumprod_prev) * current_beta / beta_prod
    posterior_xt_coeff = (
        np.sqrt(current_alpha) * (1.0 - alphas_cumprod_prev) / beta_prod
    )
    posterior_variance = np.maximum(
        (1.0 - alphas_cumprod_prev) / beta_prod * current_beta, 1e-20
    )

    tables = dict(
        betas=betas,
        alphas_cumprod=alphas_cumprod,
        sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
        posterior_x0_coeff=posterior_x0_coeff,
        posterior_xt_coeff=posterior_xt_coeff,
        posterior_variance=posterior_variance,
    )
    return DDPMSchedule(tables).to(device)
