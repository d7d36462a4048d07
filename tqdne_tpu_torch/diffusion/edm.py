"""EDM schedule, preconditioning and training loss: the port of
``tqdne_tpu/diffusion/edm.py``."""

from __future__ import annotations

import dataclasses

import torch

from tqdne_tpu_torch.parallel import draw_rows, spatial
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


def sigma_from_normal(cfg: EDMConfig, eps):
    """Map a standard-normal draw to a training sigma: exp(eps P_std + P_mean)."""
    return torch.exp(eps * cfg.P_std + cfg.P_mean)


def loss_weight(cfg: EDMConfig, sigma):
    """lambda(sigma) = (sigma^2 + sigma_data^2) / (sigma sigma_data)^2."""
    return (sigma**2 + cfg.sigma_data**2) / (sigma * cfg.sigma_data) ** 2


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


def edm_loss(cfg: EDMConfig, net_apply, sample, *, cond_signal=None, cond=None,
             sigma_eps=None, noise=None, generator: torch.Generator | None = None):
    """EDM training loss: the lambda(sigma)-weighted MSE between
    D(x + sigma n, sigma) and x, with a lognormal sigma per batch element.

    ``sigma_eps`` (B,) and ``noise`` (``sample``'s shape) are the standard-
    normal draws, injected or drawn in ``sample``'s dtype from ``generator``
    (the device's default one when None), sigma's first.  Returns a scalar;
    under a spatial scope the mean over every shard of the sample
    (``spatial.mean_over_model``).
    """
    def normal(shape):
        return draw_rows(torch.randn, shape, generator=generator, device=sample.device,
                         dtype=sample.dtype)

    sigma = sigma_from_normal(cfg, normal(sample.shape[:1]) if sigma_eps is None else sigma_eps)
    if noise is None:
        noise = normal(sample.shape)
    noisy = sample + noise * append_dims(sigma, sample.ndim)
    pred = precondition(cfg, net_apply, noisy, sigma, cond_signal=cond_signal, cond=cond)
    sq = (pred - sample) ** 2
    return spatial.mean_over_model(torch.mean(sq * append_dims(loss_weight(cfg, sigma), sq.ndim)))
