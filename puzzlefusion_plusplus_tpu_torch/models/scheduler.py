"""DDPM scheduler with the piecewise alpha-bar schedule (port of
``puzzlefusion_plusplus_tpu/models/scheduler.py``).

Epsilon prediction, ``timestep_spacing='leading'``, no clipping, ``fixed_small`` variance. The
schedule tables are float32 numpy arrays; the reverse loop runs on the host over Python int
timesteps, so each step's coefficients are float32 scalars computed on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def piecewise_alpha_bar(t: np.ndarray) -> np.ndarray:
    """Continuous alpha-bar(t), t in [0, 1]: quadratic 1 -> 0.9 up to t=0.7, then -> 0."""
    t = np.asarray(t, np.float64) * 1000.0
    early = 1.0 - 0.1 * (t / 700.0) ** 2
    late = 0.9 * (1.0 - ((t - 700.0) / 300.0) ** 2)
    return np.where(t <= 700.0, early, late)


def piecewise_betas(num_train_timesteps: int = 1000, max_beta: float = 0.999) -> np.ndarray:
    i = np.arange(num_train_timesteps, dtype=np.float64)
    betas = 1.0 - piecewise_alpha_bar((i + 1) / num_train_timesteps) / piecewise_alpha_bar(
        i / num_train_timesteps
    )
    return np.minimum(betas, max_beta).astype(np.float32)


class DDPMParams(NamedTuple):
    betas: np.ndarray  # [T] f32
    alphas: np.ndarray
    alphas_cumprod: np.ndarray
    num_train_timesteps: int

    @staticmethod
    def piecewise(num_train_timesteps: int = 1000) -> "DDPMParams":
        betas = piecewise_betas(num_train_timesteps)
        alphas = (1.0 - betas).astype(np.float32)
        cumprod = np.cumprod(alphas.astype(np.float64)).astype(np.float32)
        return DDPMParams(betas, alphas, cumprod, num_train_timesteps)


def leading_timesteps(num_train_timesteps: int, num_inference_steps: int) -> np.ndarray:
    """[950, 900, ..., 50, 0] for 1000 -> 20."""
    step_ratio = num_train_timesteps // num_inference_steps
    return (np.arange(num_inference_steps) * step_ratio).round()[::-1].copy().astype(np.int32)


def add_noise(params: DDPMParams, sample: torch.Tensor, noise: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """Forward-process noising sqrt(abar_t) x0 + sqrt(1 - abar_t) eps, in float32; ``t``
    integer timesteps over sample's leading dims (e.g. [B] against [B, P, 7])."""
    abar = torch.as_tensor(params.alphas_cumprod, device=sample.device)[t.long()]
    abar = abar.reshape(abar.shape + (1,) * (sample.dim() - abar.dim()))
    return torch.sqrt(abar) * sample + torch.sqrt(1.0 - abar) * noise


def step_coefficients(params: DDPMParams, t: int, num_inference_steps: int):
    """float32 (pred_x0 sample weight, pred_x0 noise weight, x0 coeff, sample coeff, std)."""
    f32 = np.float32
    prev_t = t - params.num_train_timesteps // num_inference_steps
    a_t = f32(params.alphas_cumprod[t])
    a_prev = f32(params.alphas_cumprod[prev_t]) if prev_t >= 0 else f32(1.0)
    beta_t = f32(1.0) - a_t
    beta_prev = f32(1.0) - a_prev
    cur_alpha = a_t / a_prev
    cur_beta = f32(1.0) - cur_alpha
    x0_coeff = np.sqrt(a_prev) * cur_beta / beta_t
    sample_coeff = np.sqrt(cur_alpha) * beta_prev / beta_t
    variance = max(beta_prev / beta_t * cur_beta, f32(1e-20))
    return np.sqrt(beta_t), np.sqrt(a_t), x0_coeff, sample_coeff, np.sqrt(f32(variance))


def step(
    params: DDPMParams,
    model_output: torch.Tensor,
    t: int,
    sample: torch.Tensor,
    noise: torch.Tensor,
    num_inference_steps: int,
) -> torch.Tensor:
    """One reverse step (diffusers DDPMScheduler.step, epsilon / fixed_small / no clip).

    ``noise`` is a standard normal of sample's shape; the variance (clamped at 1e-20) is
    added only for t > 0."""
    sq_beta, sq_a, x0_coeff, sample_coeff, std = step_coefficients(
        params, int(t), num_inference_steps
    )
    pred_x0 = (sample - float(sq_beta) * model_output) / float(sq_a)
    prev = float(x0_coeff) * pred_x0 + float(sample_coeff) * sample
    if t > 0:
        prev = prev + float(std) * noise
    return prev
