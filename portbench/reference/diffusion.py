"""Plain EDM (Karras et al. 2022) as the HighFEM recipes use it, in float32:
the rho-spaced sigma grid, the preconditioned denoiser, the deterministic
Heun and DPM-Solver++(2M) samplers, the lambda-weighted training loss, Adam
with the cosine schedule and the EMA."""

from __future__ import annotations

import math

import torch

SIGMA_MIN, SIGMA_MAX, RHO, SIGMA_DATA = 0.002, 80.0, 7.0, 0.5
P_MEAN, P_STD = -1.2, 1.2


def sigmas(num_steps: int) -> list[float]:
    """The rho-spaced grid from sigma_max to sigma_min, then 0."""
    a, b = SIGMA_MAX ** (1 / RHO), SIGMA_MIN ** (1 / RHO)
    return [(a + i / (num_steps - 1) * (b - a)) ** RHO for i in range(num_steps)] + [0.0]


def _col(v, ndim):
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


def denoise(net, x, sigma):
    """D(x, sigma) = c_skip x + c_out F(c_in x, ln(sigma) / 4); sigma is (B,)."""
    s2 = sigma**2 + SIGMA_DATA**2
    c_in, c_skip = 1 / s2.sqrt(), SIGMA_DATA**2 / s2
    c_out = sigma * SIGMA_DATA / s2.sqrt()
    out = net(x * _col(c_in, x.ndim), 0.25 * torch.log(sigma))
    return out * _col(c_out, x.ndim) + x * _col(c_skip, x.ndim)


def heun(net, noise, num_steps: int):
    """Deterministic second-order Heun: 2N - 1 network evaluations."""
    sig = sigmas(num_steps)
    x = noise.float() * sig[0]

    def d(x, s):
        return denoise(net, x, torch.full((x.shape[0],), s, device=x.device))

    for s, s_next in zip(sig[:-1], sig[1:]):
        d_cur = (x - d(x, s)) / s
        x_euler = x + d_cur * (s_next - s)
        if s_next > 0:
            d_prime = (x_euler - d(x_euler, s_next)) / s_next
            x = x + (s_next - s) * (0.5 * d_cur + 0.5 * d_prime)
        else:
            x = x_euler
    return x


def dpmpp_2m(net, noise, num_steps: int):
    """DPM-Solver++(2M) on the EDM ODE: N evaluations, the last step first order."""
    sig = sigmas(num_steps)
    x = noise.float() * sig[0]
    prev, h_prev = None, None
    for s, s_next in zip(sig[:-1], sig[1:]):
        den = denoise(net, x, torch.full((x.shape[0],), s, device=x.device))
        if s_next == 0:
            x = den
            break
        h = math.log(s) - math.log(s_next)
        if prev is not None:
            r = h_prev / h
            den_d = (1 + 1 / (2 * r)) * den - (1 / (2 * r)) * prev
        else:
            den_d = den
        x = (s_next / s) * x - math.expm1(-h) * den_d
        prev, h_prev = den, h
    return x


def loss(net, sample, sigma_eps, noise):
    """The lambda(sigma)-weighted MSE of D(x + sigma n, sigma) against x, sigma
    lognormal from ``sigma_eps``; the mean over every element."""
    sigma = torch.exp(sigma_eps * P_STD + P_MEAN)
    noisy = sample + noise * _col(sigma, sample.ndim)
    weight = (sigma**2 + SIGMA_DATA**2) / (sigma * SIGMA_DATA) ** 2
    return torch.mean((denoise(net, noisy, sigma) - sample) ** 2 * _col(weight, sample.ndim))


def cosine_lr(lr: float, max_steps: int, count: int) -> float:
    return lr * 0.5 * (1 + math.cos(math.pi * min(count, max_steps) / max_steps))


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8 on the bias-corrected root) over a dict
    of float32 tensors, one update per call, at the cosine rate of its count."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: dict, lr: float, max_steps: int):
        self.lr, self.max_steps, self.count = lr, max_steps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def update(self, params: dict, grads: dict):
        lr = cosine_lr(self.lr, self.max_steps, self.count)
        self.count += 1
        t = self.count
        for k, g in grads.items():
            self.m[k].mul_(self.B1).add_(g, alpha=1 - self.B1)
            self.v[k].mul_(self.B2).addcmul_(g, g, value=1 - self.B2)
            m_hat = self.m[k] / (1 - self.B1**t)
            v_hat = self.v[k] / (1 - self.B2**t)
            params[k].sub_(lr * m_hat / (v_hat.sqrt() + self.EPS))


@torch.no_grad()
def ema_update(ema: dict, params: dict, decay: float):
    for k, p in params.items():
        ema[k].add_((1 - decay) * (p - ema[k]))
