"""DDPM diffusion: the port of ``tqdne_tpu/diffusion/ddpm.py``.

The linear or squared-cosine beta schedule, q(x_t | x_0) noising, the MSE
loss on epsilon (or x0) prediction, the fixed-small-variance ancestral
step with x0 clipping, and the T-step sampler, which the JAX package scans
with ``lax.scan`` and the port runs as a host loop: its per-step
coefficients are host floats, so the loop costs no device sync.  Defaults
follow diffusers: T = 1000, beta linear 1e-4..0.02, clip_sample.  The
network sees t as a float in [0, T).  A conditioning signal is concatenated
before x on the channel axis, ``[cond_signal, x]``.  Every draw (the loss's
t and noise, the sampler's initial x and per-step noise) is injectable;
left out, each comes from the given ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from tqdne_tpu_torch.parallel import draw_rows
from tqdne_tpu_torch.train.state import TrainState, apply_updates
from tqdne_tpu_torch.utils import append_dims, resolve_device
from tqdne_tpu_torch.utils.tracing import span


@dataclasses.dataclass(frozen=True)
class DDPMConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    beta_schedule: str = "linear"  # "linear" | "squaredcos_cap_v2"
    clip_sample: bool = True
    prediction_type: str = "epsilon"  # "epsilon" | "sample"


def betas(cfg: DDPMConfig) -> torch.Tensor:
    """The (T,) float32 beta schedule, on the host."""
    t = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        return torch.linspace(cfg.beta_start, cfg.beta_end, t, dtype=torch.float32)
    if cfg.beta_schedule == "squaredcos_cap_v2":
        i = torch.arange(t, dtype=torch.float32)

        def f(x):
            return torch.cos((x / t + 0.008) / 1.008 * math.pi / 2) ** 2

        return torch.clip(1.0 - f(i + 1) / f(i), 0.0, 0.999)
    raise ValueError(cfg.beta_schedule)


def alphas_cumprod(cfg: DDPMConfig) -> torch.Tensor:
    return torch.cumprod(1.0 - betas(cfg), dim=0)


def add_noise(cfg: DDPMConfig, x0, noise, t):
    """q(x_t | x_0) forward noising at the integer timesteps ``t`` (B,)."""
    acp = alphas_cumprod(cfg).to(x0.device)[t]
    nd = x0.ndim
    return append_dims(torch.sqrt(acp), nd) * x0 + append_dims(torch.sqrt(1 - acp), nd) * noise


def ddpm_loss(cfg: DDPMConfig, net_apply, sample, *, cond_signal=None, cond=None, t=None,
              noise=None, generator: torch.Generator | None = None) -> torch.Tensor:
    """MSE on the epsilon (or x0) prediction; ``t`` (B,) integers in [0, T) and
    ``noise`` injected or drawn from ``generator`` in that order."""
    b = sample.shape[0]
    if t is None:
        t = draw_rows(torch.randint, 0, cfg.num_train_timesteps, (b,), generator=generator,
                      device=sample.device)
    t = t.to(sample.device)
    if noise is None:
        noise = draw_rows(torch.randn, sample.shape, generator=generator, device=sample.device,
                          dtype=sample.dtype)
    noisy = add_noise(cfg, sample, noise, t)
    x_in = noisy if cond_signal is None else torch.cat([cond_signal, noisy], dim=-1)
    pred = net_apply(x_in, t.float(), cond)
    target = noise if cfg.prediction_type == "epsilon" else sample
    return torch.mean((pred - target) ** 2)


@functools.lru_cache(maxsize=8)
def _host_schedule(cfg: DDPMConfig) -> tuple[list, list]:
    """(betas, alphas_cumprod) as host floats (the float32 values)."""
    return betas(cfg).tolist(), alphas_cumprod(cfg).tolist()


def ddpm_step(cfg: DDPMConfig, model_out, t: int, x_t, noise=None,
              generator: torch.Generator | None = None):
    """One ancestral posterior step p(x_{t-1} | x_t) (fixed-small variance, no
    noise at t = 0) at the host timestep ``t``; ``noise`` is drawn from
    ``generator`` when None (and not at all at t = 0)."""
    bet, acp = _host_schedule(cfg)
    beta_t, acp_t = bet[t], acp[t]
    acp_tm1 = acp[t - 1] if t > 0 else 1.0
    alpha_t = 1.0 - beta_t
    if cfg.prediction_type == "epsilon":
        x0 = (x_t - math.sqrt(1 - acp_t) * model_out) / math.sqrt(acp_t)
    else:
        x0 = model_out
    if cfg.clip_sample:
        x0 = torch.clip(x0, -1.0, 1.0)
    coef_x0 = math.sqrt(acp_tm1) * beta_t / (1 - acp_t)
    coef_xt = math.sqrt(alpha_t) * (1 - acp_tm1) / (1 - acp_t)
    mean = coef_x0 * x0 + coef_xt * x_t
    if t == 0:
        return mean
    if noise is None:
        noise = draw_rows(torch.randn, x_t.shape, generator=generator, device=x_t.device,
                          dtype=x_t.dtype)
    var = max((1 - acp_tm1) / (1 - acp_t) * beta_t, 1e-20)
    return mean + math.sqrt(var) * noise


@torch.no_grad()
def ddpm_sample(cfg: DDPMConfig, net_apply, shape: tuple[int, ...], *, cond_signal=None,
                cond=None, x=None, step_noise=None, generator: torch.Generator | None = None,
                device="cuda") -> torch.Tensor:
    """Full T-step ancestral sampling through ``net_apply`` (the UNet: the
    JAX ``sample_fn`` of ``make_ddpm_steps``) from ``x`` (a standard-normal
    draw of ``shape``); ``step_noise[k]`` is the noise of the k-th step
    (t = T-1-k).  Both are drawn from ``generator`` on ``device`` when None.
    float32."""
    device = resolve_device(device)
    if x is None:
        x = draw_rows(torch.randn, shape, generator=generator, device=device)
    x = x.to(device, torch.float32)
    for k, t in enumerate(range(cfg.num_train_timesteps - 1, -1, -1)):
        x_in = x if cond_signal is None else torch.cat([cond_signal, x], dim=-1)
        with span("denoise"):
            pred = net_apply(x_in, torch.full((shape[0],), float(t), device=device), cond)
        noise = None if step_noise is None else step_noise[k].to(device, torch.float32)
        x = ddpm_step(cfg, pred, t, x, noise, generator)
    return x


def make_ddpm_steps(cfg: DDPMConfig = DDPMConfig(), *, ema_decay: float = 0.999):
    """Returns (train_step, eval_step) over a ``TrainState`` on ``batch["signal"]``:
    the live module in train mode (dropout on), or the EMA module in eval
    mode; ``ddpm_sample`` is the sampling function.  ``draws`` may hold ``t``
    and ``noise``."""

    def loss_of(unet, batch: dict, draws, generator):
        draws = draws or {}
        return ddpm_loss(cfg, unet, batch["signal"], cond_signal=batch.get("cond_signal"),
                         cond=batch.get("cond"), t=draws.get("t"), noise=draws.get("noise"),
                         generator=generator)

    def train_step(state: TrainState, batch: dict, *, draws=None, generator=None):
        state.model.train()
        with span("loss"):
            loss = loss_of(state.model, batch, draws, generator)
        with span("backward"):
            loss.backward()
        apply_updates(state, ema_decay)
        return {"loss": loss.detach()}

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict, *, draws=None, generator=None):
        return {"loss": loss_of(state.ema, batch, draws, generator)}

    return train_step, eval_step
