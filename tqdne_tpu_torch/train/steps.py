"""Latent EDM sampling: the port of the ``sample_fn`` composition in
``tqdne_tpu/train/steps.py:make_edm_steps`` (cast the UNet once, integrate
the ODE in latent space, decode with the frozen autoencoder).  Training
steps come with the training slice.
"""

from __future__ import annotations

import torch

from tqdne_tpu_torch.diffusion import edm as edm_lib
from tqdne_tpu_torch.diffusion import sampler as sampler_lib


@torch.no_grad()
def sample_latent_edm(unet, autoencoder, shape: tuple[int, ...], cond=None, *,
                      edm_cfg: edm_lib.EDMConfig = edm_lib.EDMConfig(), num_steps: int = 25,
                      solver: str = "heun", cast_params=None,
                      noise=None, generator=None, device="cuda"):
    """Sample channels-last latents of ``shape`` and decode them to the
    signal (B, *spatial, C) in float32.

    ``cast_params``: cast the UNet's parameters to this dtype once, before
    the loop (the JAX ``cast_params``); the autoencoder computes in its own
    dtype.  ``noise``/``generator``: see ``diffusion.sampler.sample``.
    """
    if cast_params is not None:
        unet.to(cast_params)

    def denoise_fn(x, sigma):
        return edm_lib.precondition(edm_cfg, unet, x, sigma, cond=cond)

    latent = sampler_lib.sample(denoise_fn, shape, edm_cfg, num_steps=num_steps, solver=solver,
                                noise=noise, generator=generator, device=device)
    return autoencoder.decode(latent.float()).float()
