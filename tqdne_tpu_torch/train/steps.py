"""Latent EDM train, eval and sample steps: the port of
``tqdne_tpu/train/steps.py:make_edm_steps`` for the flagship recipe.

Batches are dicts of channels-last tensors: ``signal`` (B, *S, C) and
``cond`` (B, F), or with cached latents ``latent_mean``/``latent_log_std``.
The frozen autoencoder encodes the signal inside the step, without
gradients.  Every random draw of a step (the encoder's eps, the sigma
normal, the diffusion noise) is injectable, as the parity tests need; left
out, each comes from the step's ``generator`` in that order.  Dropout draws
from the device's default generator.
"""

from __future__ import annotations

import copy

import torch

from tqdne_tpu_torch.diffusion import edm as edm_lib
from tqdne_tpu_torch.diffusion import sampler as sampler_lib
from tqdne_tpu_torch.train.state import TrainState, apply_updates


def edm_step_loss(unet, batch: dict, edm_cfg: edm_lib.EDMConfig = edm_lib.EDMConfig(), *,
                  autoencoder=None, latent_moments: bool = False, draws: dict | None = None,
                  generator: torch.Generator | None = None):
    """The JAX ``_loss`` of ``make_edm_steps``: encode (or sample the cached
    moments), then ``edm_loss`` through ``unet``.  ``draws`` may hold
    ``ae_eps``, ``sigma_eps`` and ``noise``."""
    draws = draws or {}
    if batch.get("cond_signal") is not None:
        raise ValueError("cond_signal pairs are not ported yet")
    if latent_moments:
        mean, log_std = batch["latent_mean"], batch["latent_log_std"]
        eps = draws.get("ae_eps")
        if eps is None:
            eps = torch.randn(mean.shape, generator=generator, device=mean.device,
                              dtype=mean.dtype)
        sample = mean + eps * torch.exp(log_std)
    else:
        sample = batch["signal"]
        if autoencoder is not None:
            with torch.no_grad():
                sample = autoencoder.encode(sample, eps=draws.get("ae_eps"), generator=generator)
    return edm_lib.edm_loss(edm_cfg, unet, sample, cond=batch.get("cond"),
                            sigma_eps=draws.get("sigma_eps"), noise=draws.get("noise"),
                            generator=generator)


def make_edm_steps(edm_cfg: edm_lib.EDMConfig = edm_lib.EDMConfig(), *, autoencoder=None,
                   ema_decay: float = 0.999, latent_moments: bool = False):
    """Returns (train_step, eval_step) over a ``TrainState``.

    ``train_step(state, batch, *, draws=None, generator=None)`` runs the loss
    on the live module in train mode (dropout on), backpropagates, applies
    the optimizer and the EMA and returns ``{"loss": ...}``;
    ``eval_step(state, batch, ...)`` returns the loss of the EMA module,
    which the reference swaps in for every validation.
    """
    if latent_moments and autoencoder is None:
        raise ValueError("latent_moments requires an autoencoder (for decode)")
    if autoencoder is not None:
        autoencoder.eval().requires_grad_(False)
    kw = dict(autoencoder=autoencoder, latent_moments=latent_moments)

    def train_step(state: TrainState, batch: dict, *, draws=None, generator=None):
        state.model.train()
        loss = edm_step_loss(state.model, batch, edm_cfg, draws=draws, generator=generator, **kw)
        loss.backward()
        apply_updates(state, ema_decay)
        return {"loss": loss.detach()}

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict, *, draws=None, generator=None):
        return {"loss": edm_step_loss(state.ema, batch, edm_cfg, draws=draws,
                                      generator=generator, **kw)}

    return train_step, eval_step


@torch.no_grad()
def sample_latent_edm(unet, autoencoder, shape: tuple[int, ...], cond=None, *,
                      edm_cfg: edm_lib.EDMConfig = edm_lib.EDMConfig(), num_steps: int = 25,
                      solver: str = "heun", cast_params=None,
                      noise=None, generator=None, device="cuda"):
    """Sample channels-last latents of ``shape`` and decode them to the
    signal (B, *spatial, C) in float32: the JAX ``sample_fn``.

    ``cast_params``: sample with a copy of the UNet whose parameters are cast
    to this dtype once, before the loop (the JAX ``cast_params``); the
    caller's module keeps its dtype.  The autoencoder computes in its own
    compute dtype.  ``noise``/``generator``: see ``diffusion.sampler.sample``.
    """
    if cast_params is not None:
        unet = copy.deepcopy(unet).to(cast_params)

    def denoise_fn(x, sigma):
        return edm_lib.precondition(edm_cfg, unet, x, sigma, cond=cond)

    latent = sampler_lib.sample(denoise_fn, shape, edm_cfg, num_steps=num_steps, solver=solver,
                                noise=noise, generator=generator, device=device)
    return autoencoder.decode(latent.float()).float()
