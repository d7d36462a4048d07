"""EDM schedule and preconditioning: the port of ``tqdne_tpu/diffusion/edm.py``
(the sampling side)."""

from __future__ import annotations

import dataclasses

import torch

from tqdne_tpu_torch.utils import append_dims


@dataclasses.dataclass(frozen=True)
class EDMConfig:
    """EDM hyperparameters (defaults follow the paper)."""

    sigma_min: float = 0.002
    sigma_max: float = 80.0
    rho: float = 7.0
    sigma_data: float = 0.5
    P_mean: float = -1.2
    P_std: float = 1.2
    S_churn: float = 40.0
    S_min: float = 0.05
    S_max: float = 50.0
    S_noise: float = 1.003


def skip_scaling(cfg: EDMConfig, sigma):
    return cfg.sigma_data**2 / (sigma**2 + cfg.sigma_data**2)


def out_scaling(cfg: EDMConfig, sigma):
    return sigma * cfg.sigma_data / (sigma**2 + cfg.sigma_data**2) ** 0.5


def in_scaling(cfg: EDMConfig, sigma):
    return 1.0 / (sigma**2 + cfg.sigma_data**2) ** 0.5


def noise_conditioning(cfg: EDMConfig, sigma):
    """The network's time input: 0.25 * ln(sigma)."""
    return 0.25 * torch.log(sigma)


def sampling_sigmas(cfg: EDMConfig, num_steps: int, dtype=torch.float32) -> torch.Tensor:
    """Karras rho-spaced sigma grid of length ``num_steps`` plus a final 0,
    computed in ``dtype`` on the CPU (the samplers read it on the host)."""
    rho_inv = 1.0 / cfg.rho
    steps = torch.arange(num_steps, dtype=dtype)
    sigmas = (
        cfg.sigma_max**rho_inv
        + steps / (num_steps - 1) * (cfg.sigma_min**rho_inv - cfg.sigma_max**rho_inv)
    ) ** cfg.rho
    return torch.cat([sigmas, torch.zeros(1, dtype=dtype)])


def sigma_hat(cfg: EDMConfig, sigma: float, num_steps: int) -> float:
    """Stochastic-churn noise inflation: sigma * (1 + gamma) inside [S_min, S_max]."""
    gamma_max = min(cfg.S_churn / num_steps, 2**0.5 - 1)
    gamma = gamma_max if cfg.S_min <= sigma <= cfg.S_max else 0.0
    return sigma + gamma * sigma


def precondition(cfg: EDMConfig, net_apply, noisy, sigma, *, cond_signal=None, cond=None):
    """D(x, sigma) = c_skip x + c_out F(c_in x, c_noise) over channels-last
    ``noisy``; ``sigma`` is per batch element, shape (B,).  A conditioning
    signal is concatenated on the channel (last) axis."""
    ndim = noisy.ndim
    x_in = noisy * append_dims(in_scaling(cfg, sigma), ndim)
    if cond_signal is not None:
        x_in = torch.cat([x_in, cond_signal], dim=-1)
    out = net_apply(x_in, noise_conditioning(cfg, sigma), cond)
    skip = append_dims(skip_scaling(cfg, sigma), ndim) * noisy
    return out * append_dims(out_scaling(cfg, sigma), ndim) + skip
