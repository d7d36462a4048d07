"""Consistency models (Improved Techniques for Training Consistency Models,
arXiv 2310.14189): the port of ``tqdne_tpu/diffusion/consistency.py``.

The boundary scalings c_skip/c_out with the sigma - sigma_min offset, the
discretization doubling N(k) (initial 10 -> final 1280 grid points), the
erf-based lognormal timestep PMF over a fixed 1280-entry index space with
masking, teacher/student adjacent-sigma pairs with shared dropout masks,
the pseudo-Huber loss with c = 0.00054 sqrt(spatial size), 1/delta-sigma
weights, and 1-step sampling from sigma_max with optional refinement.

The network sees raw ``x`` and raw ``sigma`` (no EDM input scaling, no
0.25 ln sigma).  N(k) is a host float computed from the state's step
count, so the grid costs no device sync.  Every draw of a step (the
timesteps, the noise) and of the sampler (the initial and the refinement
noise) is injectable; left out, each comes from the given
``torch.Generator``.  The teacher's dropout masks equal the student's: the
device's RNG state is saved before the teacher's forward and restored
before the student's, the port's counterpart of passing both the same
dropout key.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tqdne_tpu_torch.parallel import draw_rows
from tqdne_tpu_torch.train.state import TrainState, apply_updates
from tqdne_tpu_torch.train.steps import training_sample
from tqdne_tpu_torch.utils import append_dims, resolve_device
from tqdne_tpu_torch.utils.tracing import span


@dataclasses.dataclass(frozen=True)
class ConsistencyConfig:
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    rho: float = 7.0
    sigma_data: float = 0.5
    initial_timesteps: int = 10
    final_timesteps: int = 1280
    lognormal_mean: float = -1.1
    lognormal_std: float = 2.0
    huber_c_scale: float = 0.00054


def skip_scaling(cfg: ConsistencyConfig, sigma):
    return cfg.sigma_data**2 / ((sigma - cfg.sigma_min) ** 2 + cfg.sigma_data**2)


def out_scaling(cfg: ConsistencyConfig, sigma):
    return cfg.sigma_data * (sigma - cfg.sigma_min) / (cfg.sigma_data**2 + sigma**2) ** 0.5


def num_timesteps(cfg: ConsistencyConfig, step: int, max_steps: int) -> float:
    """N(k), the number of grid points: min(initial 2^floor(k / s'), final) + 1
    with s' = max(floor(max_steps / doublings), 1) (the clamp keeps a run
    shorter than the doublings from dividing by 0)."""
    doublings = math.floor(math.log2(math.floor(cfg.final_timesteps / cfg.initial_timesteps))) + 1
    s_prime = max(math.floor(max_steps / doublings), 1)
    k = min(math.floor(step / s_prime), 64)  # past 64 doublings the minimum is final anyway
    return float(min(cfg.initial_timesteps * 2**k, cfg.final_timesteps) + 1)


def sigma_grid_value(cfg: ConsistencyConfig, i, n):
    """sigma(i, N): point ``i`` of the ascending N-point Karras grid,
    evaluated analytically."""
    rho_inv = 1.0 / cfg.rho
    lo = cfg.sigma_min**rho_inv
    hi = cfg.sigma_max**rho_inv
    return (lo + i / (n - 1.0) * (hi - lo)) ** cfg.rho


def timestep_log_pmf(cfg: ConsistencyConfig, n, max_intervals: int, device=None) -> torch.Tensor:
    """The lognormal interval log-PMF over ``max_intervals`` entries:
    p(i) ∝ erf((ln sigma_{i+1} - mu) / (s sqrt 2)) - erf((ln sigma_i - mu) / (s sqrt 2))
    for i < N - 1, -inf beyond."""
    i = torch.arange(max_intervals, dtype=torch.float32, device=device)
    s_lo = sigma_grid_value(cfg, i, n)
    s_hi = sigma_grid_value(cfg, i + 1.0, n)
    denom = cfg.lognormal_std * math.sqrt(2.0)
    pdf = torch.special.erf((torch.log(s_hi) - cfg.lognormal_mean) / denom) - torch.special.erf(
        (torch.log(s_lo) - cfg.lognormal_mean) / denom)
    valid = i < (n - 1.0)
    pdf = torch.where(valid, pdf.clamp(min=1e-30), 0.0)
    log_pmf = torch.where(valid, torch.log(pdf), -torch.inf)
    return log_pmf - torch.logsumexp(log_pmf, dim=0)


def draw_categorical(log_pmf: torch.Tensor, n: int, generator=None) -> torch.Tensor:
    """``n`` draws of the index of ``log_pmf`` by Gumbel-max, from ``generator``:
    argmax(log_pmf - log(-log u)), with no host sync."""
    u = draw_rows(torch.rand, (n, log_pmf.shape[0]), generator=generator, device=log_pmf.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))
    return torch.argmax(log_pmf + gumbel, dim=1)


def consistency_forward(cfg: ConsistencyConfig, net_apply, x, sigma, cond_signal=None, cond=None):
    """f(x, sigma) = c_skip(sigma) x + c_out(sigma) F([x, cond_signal], sigma, cond)
    over channels-last ``x``; ``sigma`` (B,)."""
    ndim = x.ndim
    x_in = x if cond_signal is None else torch.cat([x, cond_signal], dim=-1)
    out = net_apply(x_in, sigma, cond)
    return append_dims(out_scaling(cfg, sigma), ndim) * out + append_dims(
        skip_scaling(cfg, sigma), ndim) * x


def pseudo_huber(cfg: ConsistencyConfig, pred, target, sample_shape) -> torch.Tensor:
    """sqrt((pred - target)^2 + c^2) - c with c = huber_c_scale sqrt(spatial size)
    (the channels-last spatial axes of ``sample_shape``)."""
    c = cfg.huber_c_scale * math.sqrt(float(math.prod(sample_shape[1:-1])))
    return torch.sqrt((pred - target) ** 2 + c**2) - c


def consistency_loss(cfg: ConsistencyConfig, net_apply_teacher, net_apply_student,
                     sample: torch.Tensor, step: int, max_steps: int, *, cond_signal=None,
                     cond=None, timesteps=None, eps=None,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """One consistency training loss: interval indices from the masked
    lognormal PMF of N(step) grid points, the teacher at sigma_i and the
    student at sigma_{i+1} on the same noise, pseudo-Huber with 1/delta-sigma
    weights.  The teacher runs without gradients and draws the same dropout
    masks as the student.  ``timesteps`` (B,) and ``eps`` (``sample``'s
    shape) are injected or drawn from ``generator`` in that order."""
    n = num_timesteps(cfg, step, max_steps)
    if timesteps is None:
        log_pmf = timestep_log_pmf(cfg, n, cfg.final_timesteps, device=sample.device)
        timesteps = draw_categorical(log_pmf, sample.shape[0], generator)
    t = timesteps.to(device=sample.device, dtype=torch.float32)
    sigma_teacher = sigma_grid_value(cfg, t, n)
    sigma_student = sigma_grid_value(cfg, t + 1.0, n)
    if eps is None:
        eps = draw_rows(torch.randn, sample.shape, generator=generator, device=sample.device,
                        dtype=sample.dtype)
    x_teacher = sample + eps * append_dims(sigma_teacher, sample.ndim)
    x_student = sample + eps * append_dims(sigma_student, sample.ndim)
    # the device's RNG state is restored on exit, so the student redraws the teacher's masks
    cuda = [sample.device] if sample.device.type == "cuda" else []
    with torch.no_grad(), torch.random.fork_rng(devices=cuda):
        target = consistency_forward(cfg, net_apply_teacher, x_teacher, sigma_teacher,
                                     cond_signal, cond)
    pred = consistency_forward(cfg, net_apply_student, x_student, sigma_student, cond_signal,
                               cond)
    loss = pseudo_huber(cfg, pred, target, sample.shape)
    weights = 1.0 / (sigma_student - sigma_teacher)
    return torch.mean(loss * append_dims(weights, loss.ndim))


@torch.no_grad()
def consistency_sample(cfg: ConsistencyConfig, net_apply, shape: tuple[int, ...],
                       sigmas=(1.0,), cond_signal=None, cond=None, noise: str = "auto", *,
                       eps=None, refine_draws=None, generator: torch.Generator | None = None,
                       device="cuda") -> torch.Tensor:
    """One network eval from sigma_max, then one per refinement sigma.

    ``noise``: "song" (Song et al. 2023, Alg. 1: the initial draw scaled by
    sigma_max, each refinement adding sqrt(sigma^2 - sigma_min^2) N(0, 1)),
    "reference" (the reference's unscaled N(0, 1) start and uniform [0, 1)
    refinement noise times sigma) or "auto", which is "song".  ``eps`` (the
    initial standard normal) and ``refine_draws`` (one draw of ``shape`` per
    refinement sigma, normal or uniform by the convention) are injected or
    drawn from ``generator`` on ``device``.  float32."""
    if noise == "auto":
        noise = "song"
    if noise not in ("song", "reference"):
        raise ValueError(f"unknown noise mode {noise!r}; use 'auto', 'song' or 'reference'")
    device = resolve_device(device)
    if eps is None:
        eps = draw_rows(torch.randn, shape, generator=generator, device=device)
    x = eps.to(device, torch.float32)
    if noise == "song":
        x = x * cfg.sigma_max
    ones = torch.ones(shape[0], device=device)
    with span("denoise"):
        x = consistency_forward(cfg, net_apply, x, ones * cfg.sigma_max, cond_signal, cond)
    for k, sigma in enumerate(float(s) for s in sigmas):
        draw = None if refine_draws is None else refine_draws[k].to(device, torch.float32)
        if noise == "song":
            if draw is None:
                draw = draw_rows(torch.randn, shape, generator=generator, device=device)
            x = x + draw * max(sigma**2 - cfg.sigma_min**2, 0.0) ** 0.5
        else:
            if draw is None:
                draw = draw_rows(torch.rand, shape, generator=generator, device=device)
            x = x + draw * sigma
        with span("denoise"):
            x = consistency_forward(cfg, net_apply, x, ones * sigma, cond_signal, cond)
    return x


@torch.no_grad()
def sample_consistency(unet, shape: tuple[int, ...], cond=None, *, autoencoder=None,
                       cfg: ConsistencyConfig = ConsistencyConfig(), sigmas=(1.0,),
                       noise: str = "auto", parameterisation=None, cond_signal=None,
                       eps=None, refine_draws=None, generator=None,
                       device="cuda") -> torch.Tensor:
    """The JAX ``sample_fn`` of ``make_consistency_steps``: few-eval
    sampling of ``shape`` (the latent's with an ``autoencoder``, which then
    decodes it to the signal), float32.  ``parameterisation(unet) ->
    net(x, sigma, cond)`` wraps the UNet (default: the raw network;
    ``distillation.sample_distilled`` passes the EDM-conditioned one)."""
    net = unet if parameterisation is None else parameterisation(unet)
    out = consistency_sample(cfg, net, shape, sigmas, cond_signal, cond, noise, eps=eps,
                             refine_draws=refine_draws, generator=generator, device=device)
    if autoencoder is not None:
        out = autoencoder.decode(out.float())
    return out.float()


def make_consistency_steps(cfg: ConsistencyConfig, max_steps: int, *, ema_decay: float = 0.999,
                           autoencoder=None, device_representation=None,
                           latent_moments: bool = False):
    """Returns (train_step, eval_step) over a ``TrainState``, in the
    convention of ``train.steps.make_edm_steps``; ``sample_consistency`` is
    the sampling function.  With an ``autoencoder`` the model learns in the
    frozen autoencoder's latent space; ``latent_moments`` trains from the
    cached moments and ``device_representation`` computes the signal on the
    device, as in the EDM steps.

    ``train_step(state, batch, *, draws=None, generator=None)``: the live
    module in train mode is both the gradient-blocked teacher and the
    student, at N(``state.step``); ``draws`` may hold ``ae_eps``,
    ``timesteps`` and ``eps``, drawn in that order otherwise.
    ``eval_step``: the same loss through the EMA module (no dropout)."""
    if latent_moments and autoencoder is None:
        raise ValueError("latent_moments requires an autoencoder (for decode)")
    if autoencoder is not None:
        autoencoder.eval().requires_grad_(False)

    def loss_of(teacher, student, state: TrainState, batch: dict, draws, generator):
        draws = draws or {}
        sample = training_sample(batch, autoencoder=autoencoder, latent_moments=latent_moments,
                                 device_representation=device_representation,
                                 ae_eps=draws.get("ae_eps"), generator=generator)
        return consistency_loss(cfg, teacher, student, sample, state.step, max_steps,
                                cond_signal=batch.get("cond_signal"), cond=batch.get("cond"),
                                timesteps=draws.get("timesteps"), eps=draws.get("eps"),
                                generator=generator)

    def train_step(state: TrainState, batch: dict, *, draws=None, generator=None):
        state.model.train()
        with span("loss"):
            loss = loss_of(state.model, state.model, state, batch, draws, generator)
        with span("backward"):
            loss.backward()
        apply_updates(state, ema_decay)
        return {"loss": loss.detach()}

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict, *, draws=None, generator=None):
        return {"loss": loss_of(state.ema, state.ema, state, batch, draws, generator)}

    return train_step, eval_step
