"""Model, loader and sampler assembly for the flagship ``latent_edm`` recipe:
the port of ``tqdne_tpu/cli/common.py`` (``InferenceBundle`` with its
fixed-batch ``sampler`` for serving, ``build_inference``, ``parse_dtype``,
``ensure_dataset``, ``make_loaders``, ``build_unet``, ``build_autoencoder``,
``dataset_feature_stats`` and the flags the train CLI reads).

Weights come from ``.pt`` state dicts written by
``python -m tqdne_tpu_torch.utils.convert`` from the JAX package's flax
artifacts.  A model given no weights file gets seeded random weights
(``utils.randomize_``), which is what smoke runs and tests use.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from tqdne_tpu_torch import configs
from tqdne_tpu_torch.data.dataset import Dataset, make_synthetic_dataset
from tqdne_tpu_torch.data.pipeline import BatchLoader
from tqdne_tpu_torch.models.autoencoder import AutoencoderKL
from tqdne_tpu_torch.models.unet import UNet
from tqdne_tpu_torch.nn.layers import set_compute_dtype
from tqdne_tpu_torch.train.steps import sample_latent_edm
from tqdne_tpu_torch.utils import randomize_, resolve_device

logger = logging.getLogger("tqdne_tpu_torch")

RECIPES = ("latent_edm",)  # the ported recipes; the others come with later slices
RUN_NAME = "Latent-EDM-32x32x8-LogSpectrogram"  # the flagship run's name under outputs/
DTYPES = {"f32": torch.float32, "float32": torch.float32, "bf16": torch.bfloat16,
          "bfloat16": torch.bfloat16}
TINY_CHANNELS = 32  # model_channels of the --tiny UNet and autoencoder


def parse_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def load_weights(module: torch.nn.Module, weights, seed: int) -> torch.nn.Module:
    """Load a ``.pt`` state dict, or fill seeded random weights when None."""
    if weights is None:
        return randomize_(module, seed)
    module.load_state_dict(torch.load(weights, map_location="cpu", weights_only=True))
    return module


def build_autoencoder(config, dtype=None, *, tiny: bool = False):
    """The flagship 2D autoencoder computing in ``dtype`` over f32 parameters
    (None: in its weights' dtype); returns (module, encoder config, decoder
    config)."""
    enc_cfg, dec_cfg = configs.get_2d_autoencoder_configs(config)
    if tiny:
        enc_cfg = enc_cfg | {"model_channels": TINY_CHANNELS}
        dec_cfg = dec_cfg | {"model_channels": TINY_CHANNELS}
    return set_compute_dtype(AutoencoderKL(enc_cfg, dec_cfg), dtype), enc_cfg, dec_cfg


def build_unet(config, in_channels: int, out_channels: int, dtype=None, **overrides):
    """The flagship 2D UNet computing in ``dtype`` over f32 parameters (None:
    in its weights' dtype); returns (module, its config)."""
    ucfg = configs.get_2d_unet_config(config, in_channels, out_channels) | overrides
    return set_compute_dtype(UNet(**ucfg), dtype), ucfg


def signal_shape(config) -> tuple[int, ...]:
    """Channels-last (F, frames, C) of one example's representation."""
    sig = config.make_representation().get_representation(
        torch.zeros(1, config.channels, config.t))
    return tuple(sig.movedim(1, -1).shape[1:])


def latent_shape(enc_cfg: dict, sig_shape: tuple[int, ...]) -> tuple[int, ...]:
    """Channels-last latent shape: one stride-2 convolution per extra level."""
    factor = 2 ** (len(enc_cfg["channel_mult"]) - 1)
    return (*(-(-s // factor) for s in sig_shape[:-1]), enc_cfg["out_channels"] // 2)


def ensure_dataset(config, synthetic_n: int | None):
    """Create a synthetic dataset if asked and no real one exists."""
    if not Path(config.datapath).exists():
        if not synthetic_n:
            raise FileNotFoundError(
                f"dataset not found: {config.datapath}. Build it with the JAX package's "
                "tqdne-build-dataset, or pass --synthetic N for a smoke run.")
        logger.warning("no dataset at %s: generating synthetic data (n=%d)", config.datapath,
                       synthetic_n)
        make_synthetic_dataset(config.datapath, n=synthetic_n, t=config.t)


def make_loaders(config, batch_size: int, *, cond: bool, device, val_batch: int | None = None,
                 keys=("signal", "cond")):
    """Train and validation ``BatchLoader``s over the HDF5 dataset; returns
    (train, validation, representation)."""
    representation = config.make_representation()
    ds_train = Dataset(config.datapath, representation, cut=config.t, cond=cond, split="train")
    ds_val = Dataset(config.datapath, representation, cut=config.t, cond=cond,
                     split="validation")
    vb = val_batch or max(1, min(batch_size, len(ds_val)))
    train_loader = BatchLoader(ds_train, batch_size, device=device, keys=keys)
    val_loader = BatchLoader(ds_val, vb, shuffle=False, drop_last=True, device=device, keys=keys)
    return train_loader, val_loader, representation


def add_common_args(parser):
    """The flags of ``tqdne_tpu.cli.common.add_common_args`` the train CLI reads,
    plus ``--device`` and ``--ae-weights``; the JAX-only ones are accepted so
    that they can be refused loudly."""
    parser.add_argument("--workdir", type=str, required=True,
                        help="working directory (data/ and outputs/ live here)")
    parser.add_argument("-b", "--batchsize", type=int, default=None)
    parser.add_argument("--max-epochs", type=int, default=None)
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--dtype", type=str, default="bf16", choices=["f32", "bf16"],
                        help="compute dtype (parameters are always f32)")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="if no dataset exists, generate a synthetic one with N examples")
    parser.add_argument("--ae-weights", type=str, required=True,
                        help="frozen autoencoder state dict (.pt) from "
                             "tqdne_tpu_torch.utils.convert")
    parser.add_argument("--no-resume", action="store_true")
    parser.add_argument("--val-every", type=int, default=1,
                        help="validation-loss pass period in epochs")
    parser.add_argument("--checkpoint-every", type=int, default=1,
                        help="checkpoint period in epochs")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tiny", action="store_true",
                        help="shrink model widths for smoke runs (32-channel UNet and AE)")
    # not ported yet: refused in cli.train
    parser.add_argument("--cached-latents", action="store_true", help="not ported yet")
    parser.add_argument("--device-representation", action="store_true", help="not ported yet")
    parser.add_argument("--skip-nonfinite", type=int, default=0, help="not ported yet")
    return parser


class InferenceBundle:
    """A sampleable flagship model: UNet, frozen autoencoder and the
    representation that turns decoded spectrograms into waveforms."""

    def __init__(self, config, representation, unet, autoencoder, model_shape, *,
                 num_steps: int, solver: str, device: torch.device):
        self.config = config
        self.representation = representation
        self.unet = unet
        self.autoencoder = autoencoder
        self.model_shape = model_shape  # channels-last latent shape, no batch
        self.num_steps = num_steps
        self.solver = solver
        self.device = device

    @property
    def t(self) -> int:
        return self.config.t

    def sample(self, cond: torch.Tensor, *, noise=None, generator=None) -> torch.Tensor:
        """Normalised conditioning (B, 5) -> decoded signal (B, F, frames, C), f32."""
        cond = cond.to(self.device, torch.float32)
        return sample_latent_edm(
            self.unet, self.autoencoder, (cond.shape[0], *self.model_shape), cond,
            num_steps=self.num_steps, solver=self.solver, noise=noise, generator=generator,
            device=self.device)

    def generate(self, cond: torch.Tensor, *, noise=None, init_phase=None,
                 generator=None) -> torch.Tensor:
        """Normalised conditioning (B, 5) -> waveforms (B, 3, t), f32."""
        return self.invert(self.sample(cond, noise=noise, generator=generator),
                           init_phase=init_phase, generator=generator)

    def invert(self, signal: torch.Tensor, *, init_phase=None, generator=None) -> torch.Tensor:
        """Decoded channels-last signal (B, F, frames, C) -> waveforms (B, 3, t)
        through Griffin-Lim on the signal's device."""
        wave = self.representation.invert_representation(
            signal.movedim(-1, 1), init_phase=init_phase, generator=generator)
        return wave[..., : self.t]

    def padded_cond(self, cond, batch_size: int) -> torch.Tensor:
        """Normalised conditioning rows (n <= batch_size, 5) on the bundle's
        device, padded with zero rows to ``batch_size``.  From the host they
        cross through pinned memory without waiting on the device."""
        cond = torch.as_tensor(np.asarray(cond, np.float32))
        pad = batch_size - len(cond)
        if pad < 0:
            raise ValueError(f"{len(cond)} conditioning rows exceed the batch of {batch_size}")
        if pad:
            cond = torch.cat([cond, cond.new_zeros(pad, cond.shape[1])])
        if self.device.type == "cuda":
            return cond.pin_memory().to(self.device, non_blocking=True)
        return cond.to(self.device)

    def sampler(self, batch_size: int):
        """``run(seed, cond) -> waveforms`` at one fixed device batch (the JAX
        ``jit_sample`` with the inversion folded in): up to ``batch_size``
        normalised conditioning rows, padded with zero rows, so each seeded
        result is independent of how requests were packed.  The noise and
        Griffin-Lim's initial phase come from a ``torch.Generator`` on the
        bundle's device seeded with ``seed`` (``utils.fold_seed`` makes one
        from a request seed and an offset).  Returns the (batch_size, 3, t)
        f32 waveforms on the device, without synchronising."""
        def run(seed: int, cond) -> torch.Tensor:
            generator = torch.Generator(device=self.device).manual_seed(seed)
            return self.generate(self.padded_cond(cond, batch_size), generator=generator)

        return run


@torch.no_grad()
def build_inference(recipe_key: str = "latent_edm", *, unet_weights=None, ae_weights=None,
                    dtype=torch.bfloat16, num_steps: int = 25, solver: str = "heun",
                    gl_iters: int | None = None, device="cuda", tiny: bool = False,
                    init_seed: int = 0) -> InferenceBundle:
    """Build the flagship sampler on ``device`` (``cuda`` unless asked).

    ``dtype``: compute dtype; bf16 casts the bundle's UNet parameters once
    (the JAX ``cast_params``) and runs the autoencoder's convolutions in bf16.
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

    autoencoder, enc_cfg, _ = build_autoencoder(config, dtype, tiny=tiny)
    load_weights(autoencoder, ae_weights, init_seed + 1)
    model_shape = latent_shape(enc_cfg, signal_shape(config))
    unet, _ = build_unet(config, model_shape[-1], model_shape[-1],
                         model_channels=TINY_CHANNELS if tiny else 128)
    load_weights(unet, unet_weights, init_seed)
    if dtype == torch.bfloat16:
        unet.to(dtype)  # the bundle's own UNet: its parameters are cast once
    for module in (unet, autoencoder):
        module.to(device).eval()
        if device.type == "cuda":
            module.to(memory_format=torch.channels_last)
    return InferenceBundle(config, representation, unet, autoencoder, model_shape,
                           num_steps=num_steps, solver=solver, device=device)


def dataset_feature_stats(config) -> np.ndarray:
    """(5, 2) [mean, std] of the raw conditioning features of the dataset:
    the normalisation derived from data instead of the published table."""
    import h5py

    with h5py.File(config.datapath, "r", locking=False) as f:
        columns = [f[key][:] for key in config.features_keys]
    return np.array([[float(c.mean()), float(c.std())] for c in columns])
