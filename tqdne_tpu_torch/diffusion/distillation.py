"""Consistency distillation (CD) from a trained EDM teacher (Song et al. 2023,
arXiv 2303.01469 §4): the port of ``tqdne_tpu/diffusion/distillation.py``.

A step draws an interval of a static ``n_grid``-point Karras grid
uniformly, diffuses the sample to its upper sigma, runs one Heun step of
the frozen teacher down to its lower sigma, and regresses the student's
consistency output at the upper point onto the EMA target network's output
at the teacher-solved lower point (pseudo-Huber).  The student reuses the
teacher's EDM input scaling c_in(sigma) and noise conditioning
0.25 ln sigma inside the consistency boundary scalings, so a student
initialised from the teacher's weights starts from coherent activations.

The teacher is a separate frozen module; the student is the live module
in train mode; the target is the EMA module in eval mode, which is also
the deployed student.  The interval and the noise are injectable; left
out, they come from the step's generator in that order.
"""

from __future__ import annotations

import torch

from tqdne_tpu_torch.diffusion import edm as edm_lib
from tqdne_tpu_torch.diffusion.consistency import (
    ConsistencyConfig,
    consistency_forward,
    pseudo_huber,
    sample_consistency,
    sigma_grid_value,
)
from tqdne_tpu_torch.parallel import draw_rows
from tqdne_tpu_torch.train.state import TrainState, apply_updates
from tqdne_tpu_torch.train.steps import training_sample
from tqdne_tpu_torch.utils import append_dims
from tqdne_tpu_torch.utils.tracing import span


def edm_conditioned_net(unet, edm_cfg: edm_lib.EDMConfig, *, train: bool = False):
    """A ``net(x, sigma, cond)`` whose raw network sees the teacher's input
    scaling and noise conditioning: F(c_in(sigma) x, 0.25 ln sigma, cond).
    ``consistency_forward`` puts the boundary scalings around it.  ``train``
    sets the module's mode (dropout) for the call."""

    def net(x, sigma, cond):
        if unet.training != train:
            unet.train(train)
        x_in = x * append_dims(edm_lib.in_scaling(edm_cfg, sigma), x.ndim)
        return unet(x_in, edm_lib.noise_conditioning(edm_cfg, sigma), cond)

    return net


def teacher_heun_step(edm_cfg: edm_lib.EDMConfig, teacher_denoise, x_hi, sigma_hi, sigma_lo,
                      cond=None):
    """One deterministic Heun PF-ODE step of the frozen teacher from
    ``sigma_hi`` down to ``sigma_lo`` (> 0): two teacher evaluations."""
    ndim = x_hi.ndim
    h = append_dims(sigma_lo - sigma_hi, ndim)
    d = (x_hi - teacher_denoise(x_hi, sigma_hi, cond)) / append_dims(sigma_hi, ndim)
    x_euler = x_hi + h * d
    d2 = (x_euler - teacher_denoise(x_euler, sigma_lo, cond)) / append_dims(sigma_lo, ndim)
    return x_hi + h * 0.5 * (d + d2)


def distillation_loss(cm_cfg: ConsistencyConfig, edm_cfg: edm_lib.EDMConfig, teacher_denoise,
                      student_net, target_net, sample: torch.Tensor, n_grid: int, *, cond=None,
                      i=None, eps=None, generator: torch.Generator | None = None) -> torch.Tensor:
    """One CD loss: ``i`` (B,) uniform in [0, n_grid - 1) and ``eps``
    (``sample``'s shape) injected or drawn from ``generator`` in that order;
    the teacher's Heun step and the target's output without gradients."""
    batch = sample.shape[0]
    if i is None:
        i = draw_rows(torch.randint, 0, n_grid - 1, (batch,), generator=generator,
                      device=sample.device)
    i = i.to(device=sample.device, dtype=torch.float32)
    sigma_lo = sigma_grid_value(cm_cfg, i, float(n_grid))
    sigma_hi = sigma_grid_value(cm_cfg, i + 1.0, float(n_grid))
    if eps is None:
        eps = draw_rows(torch.randn, sample.shape, generator=generator, device=sample.device,
                        dtype=sample.dtype)
    x_hi = sample + eps * append_dims(sigma_hi, sample.ndim)
    with torch.no_grad():
        x_lo = teacher_heun_step(edm_cfg, teacher_denoise, x_hi, sigma_hi, sigma_lo, cond)
        target = consistency_forward(cm_cfg, target_net, x_lo, sigma_lo, None, cond)
    pred = consistency_forward(cm_cfg, student_net, x_hi, sigma_hi, None, cond)
    return torch.mean(pseudo_huber(cm_cfg, pred, target, sample.shape))


@torch.no_grad()
def sample_distilled(unet, shape: tuple[int, ...], cond=None, *,
                     edm_cfg: edm_lib.EDMConfig = edm_lib.EDMConfig(), **kwargs) -> torch.Tensor:
    """The JAX ``sample_fn`` of ``make_distillation_steps``: few-eval
    consistency sampling with the CD parameterisation (the UNet in eval
    mode); the keywords are ``consistency.sample_consistency``'s."""
    return sample_consistency(unet, shape, cond,
                              parameterisation=lambda u: edm_conditioned_net(u, edm_cfg),
                              **kwargs)


def make_distillation_steps(teacher, *, cm_cfg: ConsistencyConfig = ConsistencyConfig(),
                            edm_cfg: edm_lib.EDMConfig = edm_lib.EDMConfig(), n_grid: int = 18,
                            ema_decay: float = 0.95, autoencoder=None,
                            device_representation=None, latent_moments: bool = False):
    """Returns (train_step, eval_step) over a ``TrainState``, distilling the
    frozen EDM ``teacher`` (a separate module, put in eval mode without
    gradients); ``sample_distilled`` is the sampling function.

    ``ema_decay`` is the CD target-network decay mu (the paper's 0.95): the
    state's EMA module is the target network and the deployed student.
    ``train_step(state, batch, *, draws=None, generator=None)``: ``draws``
    may hold ``ae_eps``, ``i`` and ``eps``.  ``eval_step`` runs the loss with
    the EMA module as the student too, in train mode, as the JAX eval step
    passes the EMA parameters with ``train=True``."""
    if latent_moments and autoencoder is None:
        raise ValueError("latent_moments requires an autoencoder (for decode)")
    for frozen in (teacher, autoencoder):
        if frozen is not None:
            frozen.eval().requires_grad_(False)

    def teacher_denoise(x, sigma, cond):
        return edm_lib.precondition(edm_cfg, teacher, x, sigma, cond=cond)

    def loss_of(student, state: TrainState, batch: dict, draws, generator):
        draws = draws or {}
        sample = training_sample(batch, autoencoder=autoencoder, latent_moments=latent_moments,
                                 device_representation=device_representation,
                                 ae_eps=draws.get("ae_eps"), generator=generator)
        return distillation_loss(
            cm_cfg, edm_cfg, teacher_denoise, edm_conditioned_net(student, edm_cfg, train=True),
            edm_conditioned_net(state.ema, edm_cfg), sample, n_grid, cond=batch.get("cond"),
            i=draws.get("i"), eps=draws.get("eps"), generator=generator)

    def train_step(state: TrainState, batch: dict, *, draws=None, generator=None):
        with span("loss"):
            loss = loss_of(state.model, state, batch, draws, generator)
        with span("backward"):
            loss.backward()
        apply_updates(state, ema_decay)
        return {"loss": loss.detach()}

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict, *, draws=None, generator=None):
        try:
            return {"loss": loss_of(state.ema, state, batch, draws, generator)}
        finally:
            state.ema.eval()

    return train_step, eval_step
