"""Inference assembly: the port of ``InferenceBundle``/``build_inference`` in
``tqdne_tpu/cli/common.py``, for the flagship ``latent_edm`` recipe.

Weights come from ``.pt`` state dicts written by
``python -m tqdne_tpu_torch.utils.convert`` from the JAX package's flax
artifacts.  A model given no weights file gets seeded random weights
(``utils.randomize_``), which is what smoke runs and tests use.
"""

from __future__ import annotations

import torch

from tqdne_tpu_torch import configs
from tqdne_tpu_torch.models.autoencoder import AutoencoderKL
from tqdne_tpu_torch.models.unet import UNet
from tqdne_tpu_torch.train.steps import sample_latent_edm
from tqdne_tpu_torch.utils import randomize_, resolve_device

RECIPES = ("latent_edm",)  # the ported recipes; the others come with later slices
DTYPES = {"f32": torch.float32, "float32": torch.float32, "bf16": torch.bfloat16,
          "bfloat16": torch.bfloat16}


def _load(module: torch.nn.Module, weights, seed: int):
    if weights is None:
        return randomize_(module, seed)
    module.load_state_dict(torch.load(weights, map_location="cpu", weights_only=True))
    return module


class InferenceBundle:
    """A sampleable flagship model: UNet, frozen autoencoder and the
    representation that turns decoded spectrograms into waveforms."""

    def __init__(self, config, representation, unet, autoencoder, model_shape, *,
                 num_steps: int, solver: str, cast_params, device: torch.device):
        self.config = config
        self.representation = representation
        self.unet = unet
        self.autoencoder = autoencoder
        self.model_shape = model_shape  # channels-last latent shape, no batch
        self.num_steps = num_steps
        self.solver = solver
        self.cast_params = cast_params
        self.device = device

    @property
    def t(self) -> int:
        return self.config.t

    def sample(self, cond: torch.Tensor, *, noise=None, generator=None) -> torch.Tensor:
        """Normalised conditioning (B, 5) -> decoded signal (B, F, frames, C), f32."""
        cond = cond.to(self.device, torch.float32)
        return sample_latent_edm(
            self.unet, self.autoencoder, (cond.shape[0], *self.model_shape), cond,
            num_steps=self.num_steps, solver=self.solver, cast_params=self.cast_params,
            noise=noise, generator=generator, device=self.device)

    def generate(self, cond: torch.Tensor, *, noise=None, init_phase=None,
                 generator=None) -> torch.Tensor:
        """Normalised conditioning (B, 5) -> waveforms (B, 3, t), f32."""
        signal = self.sample(cond, noise=noise, generator=generator)
        wave = self.representation.invert_representation(
            signal.movedim(-1, 1), init_phase=init_phase, generator=generator)
        return wave[..., : self.t]


@torch.no_grad()
def build_inference(recipe_key: str = "latent_edm", *, unet_weights=None, ae_weights=None,
                    dtype=torch.bfloat16, num_steps: int = 25, solver: str = "heun",
                    gl_iters: int | None = None, device="cuda", tiny: bool = False,
                    init_seed: int = 0) -> InferenceBundle:
    """Build the flagship sampler on ``device`` (``cuda`` unless asked).

    ``dtype``: compute dtype; bf16 casts the UNet's parameters once (the
    JAX ``cast_params``) and runs the autoencoder's convolutions in bf16.
    ``tiny``: 32-channel UNet and autoencoder (the JAX ``--tiny`` widths).
    ``init_seed`` seeds the random weights of a model given no weights file.
    """
    if recipe_key not in RECIPES:
        raise SystemExit(f"recipe {recipe_key!r} is not ported yet (have: {RECIPES})")
    if solver not in ("heun", "dpmpp_2m"):
        raise SystemExit(f"unknown solver {solver!r}; use 'heun' or 'dpmpp_2m'")
    device = resolve_device(device)
    config = configs.LatentSpectrogramConfig()
    if gl_iters is not None:
        config.griffin_lim_iters = gl_iters
    representation = config.make_representation()
    sig = representation.get_representation(torch.zeros(1, config.channels, config.t))
    sig_shape = tuple(sig.movedim(1, -1).shape[1:])  # channels-last (F, frames, C)

    enc_cfg, dec_cfg = configs.get_2d_autoencoder_configs(config)
    if tiny:
        enc_cfg, dec_cfg = enc_cfg | {"model_channels": 32}, dec_cfg | {"model_channels": 32}
    autoencoder = _load(AutoencoderKL(enc_cfg, dec_cfg), ae_weights, init_seed + 1)
    factor = 2 ** (len(enc_cfg["channel_mult"]) - 1)  # one stride-2 conv per extra level
    model_shape = (*(-(-s // factor) for s in sig_shape[:-1]), enc_cfg["out_channels"] // 2)

    ucfg = configs.get_2d_unet_config(config, model_shape[-1], model_shape[-1],
                                      model_channels=32 if tiny else 128)
    unet = _load(UNet(**ucfg), unet_weights, init_seed)

    autoencoder.set_compute_dtype(dtype)
    for module in (unet, autoencoder):
        module.to(device).eval()
        if device.type == "cuda":
            module.to(memory_format=torch.channels_last)
    return InferenceBundle(config, representation, unet, autoencoder, model_shape,
                           num_steps=num_steps, solver=solver,
                           cast_params=dtype if dtype == torch.bfloat16 else None, device=device)
