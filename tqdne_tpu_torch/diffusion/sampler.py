"""EDM samplers: the port of ``tqdne_tpu/diffusion/sampler.py``.

The JAX package scans the sigma schedule inside one jit and skips the
second-order correction of the final step with a ``lax.cond``.  Here the
schedule lives on the host as Python floats, so that branch, and every
per-step coefficient, costs no device sync; the loop runs eagerly.  The
accumulator dtype is the dtype of ``eps`` (float64 for parity runs).

With a spatial ``mesh`` (``parallel.spatial``) each rank integrates its block
of the sample, the network under the spatial scope, from its block of the
noise drawn at the global shape (the JAX ``eps_sharding``), and the result is
gathered.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from tqdne_tpu_torch.diffusion.edm import EDMConfig, sampling_sigmas, sigma_hat
from tqdne_tpu_torch.parallel import draw_rows, spatial
from tqdne_tpu_torch.utils import resolve_device
from tqdne_tpu_torch.utils.tracing import span

# DenoiseFn(x, sigma[B]) -> denoised x; closes over the network and conditioning.
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _host(sigmas) -> list[float]:
    return sigmas.tolist() if isinstance(sigmas, torch.Tensor) else [float(s) for s in sigmas]


def _denoiser(denoise_fn: DenoiseFn, eps: torch.Tensor):
    """The network sees f32 inputs; its output returns in the accumulator dtype."""
    acc_dtype, batch = eps.dtype, eps.shape[0]

    def denoise(x, sigma: float):
        with span("denoise"):
            s = torch.full((batch,), sigma, dtype=torch.float32, device=x.device)
            return denoise_fn(x.float(), s).to(acc_dtype)

    return denoise


def heun_deterministic(denoise_fn: DenoiseFn, eps: torch.Tensor, sigmas) -> torch.Tensor:
    """Deterministic 2nd-order Heun: 2N-1 network evaluations.

    ``eps`` is already scaled by sigmas[0]; ``sigmas`` has length N+1 and
    ends with 0.
    """
    denoise = _denoiser(denoise_fn, eps)
    sig = _host(sigmas)
    x = eps
    for sigma, sigma_next in zip(sig[:-1], sig[1:]):
        d_cur = (x - denoise(x, sigma)) / sigma
        x_euler = x + d_cur * (sigma_next - sigma)
        if sigma_next > 0:
            d_prime = (x_euler - denoise(x_euler, sigma_next)) / sigma_next
            x = x + (sigma_next - sigma) * (0.5 * d_cur + 0.5 * d_prime)
        else:
            x = x_euler
    return x


def heun_stochastic(denoise_fn: DenoiseFn, eps: torch.Tensor, sigmas, cfg: EDMConfig, *,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """Stochastic-churn Heun; the churn noise is drawn from ``generator``."""
    denoise = _denoiser(denoise_fn, eps)
    sig = _host(sigmas)
    num_steps = len(sig) - 1
    x = eps
    for sigma, sigma_next in zip(sig[:-1], sig[1:]):
        s_hat = sigma_hat(cfg, sigma, num_steps)
        noise = draw_rows(torch.randn, x.shape, generator=generator, dtype=x.dtype,
                          device=x.device)
        x_hat = x + noise * cfg.S_noise * math.sqrt(max(s_hat**2 - sigma**2, 0.0))
        d_cur = (x_hat - denoise(x_hat, s_hat)) / s_hat
        x_euler = x_hat + d_cur * (sigma_next - s_hat)
        if sigma_next > 0:
            d_prime = (x_euler - denoise(x_euler, sigma_next)) / sigma_next
            x = x_hat + (sigma_next - s_hat) * (0.5 * d_cur + 0.5 * d_prime)
        else:
            x = x_euler
    return x


def dpmpp_2m(denoise_fn: DenoiseFn, eps: torch.Tensor, sigmas) -> torch.Tensor:
    """DPM-Solver++(2M) for the EDM probability-flow ODE: N evaluations.

    Reuses the previous step's denoiser output; the first step has no
    history and the final sigma=0 step takes no correction.
    """
    denoise = _denoiser(denoise_fn, eps)
    tiny = torch.finfo(eps.dtype).tiny
    sig = _host(sigmas)

    def lam(sigma):  # -log sigma, sigma = 0 clamped to the dtype's tiny
        return -math.log(max(sigma, tiny))

    x, denoised_prev, h_prev = eps, None, -1.0
    for sigma, sigma_next in zip(sig[:-1], sig[1:]):
        denoised = denoise(x, sigma)
        h = lam(sigma_next) - lam(sigma)
        if h_prev > 0 and sigma_next > 0:
            coef = 1.0 / (2.0 * max(h_prev / h, tiny))
            denoised_d = (1.0 + coef) * denoised - coef * denoised_prev
        else:
            denoised_d = denoised
        x = (sigma_next / max(sigma, tiny)) * x - math.expm1(-h) * denoised_d
        denoised_prev, h_prev = denoised, h
    return x


def sample(denoise_fn: DenoiseFn, shape: tuple[int, ...], cfg: EDMConfig = EDMConfig(), *,
           num_steps: int = 25, deterministic: bool = True, solver: str = "heun",
           noise: torch.Tensor | None = None, generator: torch.Generator | None = None,
           device="cuda", mesh=None) -> torch.Tensor:
    """Integrate the EDM probability-flow ODE from ``noise`` (a standard-normal
    draw of ``shape``; drawn from ``generator`` on ``device`` when None) with
    f32 accumulators (float64 ones for a float64 ``noise``, as parity tests
    take them).

    solver: "heun" (2N-1 evaluations) or "dpmpp_2m" (N, deterministic only).
    mesh: a spatial mesh; ``shape`` and ``noise`` are then global, each rank
    integrates its block under ``spatial_scope(mesh)`` and every rank returns
    the whole gathered result.
    """
    if mesh is not None:
        with spatial.spatial_scope(mesh) as scope:
            x = sample(denoise_fn, spatial.local_shape(scope, shape), cfg, num_steps=num_steps,
                       deterministic=deterministic, solver=solver, generator=generator,
                       noise=None if noise is None else spatial.shard(mesh, noise, "noise"),
                       device=device)
        return spatial.gather_signal(mesh, x)
    if solver not in ("heun", "dpmpp_2m"):
        raise ValueError(f"unknown solver {solver!r}; use 'heun' or 'dpmpp_2m'")
    if solver == "dpmpp_2m" and not deterministic:
        raise ValueError("dpmpp_2m is a deterministic solver")
    sigmas = sampling_sigmas(cfg, num_steps)
    if noise is None:
        noise = draw_rows(torch.randn, shape, generator=generator, device=resolve_device(device))
    eps = noise.to(torch.promote_types(noise.dtype, torch.float32)) * sigmas[0].item()
    if solver == "dpmpp_2m":
        return dpmpp_2m(denoise_fn, eps, sigmas)
    if deterministic:
        return heun_deterministic(denoise_fn, eps, sigmas)
    return heun_stochastic(denoise_fn, eps, sigmas, cfg, generator=generator)
