"""Model, loader and sampler assembly for the ported recipes, 1D and 2D: the
port of ``tqdne_tpu/cli/common.py`` (``InferenceBundle`` with its
fixed-batch ``sampler`` for serving, ``build_inference``, ``parse_dtype``,
``ensure_dataset``, ``make_loaders``, ``build_unet``, ``build_autoencoder``,
``load_ae_variables`` as ``frozen_autoencoder``, ``signal_shape``,
``dataset_feature_stats`` and the flags the train CLI reads), and the table
of ported recipes (``RECIPES``, the JAX ``tqdne_tpu/cli/train.py:RECIPES``)
that every CLI reads, with the port's own ``latent_dit`` (DiT-XL/2 in the
flagship's place, ``models.dit``).  A recipe's ``network`` (``unet`` or
``dit``) chooses the denoiser on every route: ``build_network`` at the preset,
``stored_network`` at the widths a run's ``hparams.json`` or an artifact's
manifest stores under that key.

Weights come from ``.pt`` state dicts written by
``python -m tqdne_tpu_torch.utils.convert`` from the JAX package's flax
artifacts, from the reference's Lightning checkpoints (converted on the fly
by ``utils.torch_convert``, or imported into runs by
``cli.import_checkpoint``), from artifacts of ``cli.export_weights``, or
from the port's own runs under ``outputs/``.  A model given none gets seeded
random weights (``utils.randomize_``), which is what smoke runs and tests use.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import socket
from pathlib import Path

import numpy as np
import torch

from tqdne_tpu_torch import configs
from tqdne_tpu_torch.data.dataset import CachedLatentsDataset, Dataset, make_synthetic_dataset
from tqdne_tpu_torch.data.pipeline import BatchLoader, DeviceResidentLoader
from tqdne_tpu_torch.data.representation import Identity, invert
from tqdne_tpu_torch.diffusion import ddpm as ddpm_lib
from tqdne_tpu_torch.diffusion.consistency import sample_consistency
from tqdne_tpu_torch.diffusion.distillation import sample_distilled
from tqdne_tpu_torch.models.autoencoder import AutoencoderKL
from tqdne_tpu_torch.models.dit import DiT
from tqdne_tpu_torch.models.unet import UNet
from tqdne_tpu_torch.nn.layers import set_compute_dtype
from tqdne_tpu_torch.nn.quant import int8_scope
from tqdne_tpu_torch.parallel import barrier, rank, replicate_, whole_batch, world_size
from tqdne_tpu_torch.parallel.spatial import spatial_mesh
from tqdne_tpu_torch.train.checkpoint import Checkpointer, hparams_diff
from tqdne_tpu_torch.train.steps import sample_edm
from tqdne_tpu_torch.utils import randomize_, resolve_device
from tqdne_tpu_torch.utils.convert import flax_to_state_dict
from tqdne_tpu_torch.utils.tracing import span
from tqdne_tpu_torch.utils.torch_convert import (
    convert_autoencoder,
    convert_unet,
    load_lightning_checkpoint,
)

logger = logging.getLogger("tqdne_tpu_torch")

RUN_NAME = "Latent-EDM-32x32x8-LogSpectrogram"  # the flagship run's name under outputs/
AE_NAME = "Autoencoder-32x32x4-LogSpectrogram"  # its frozen autoencoder's run
DTYPES = {"f32": torch.float32, "float32": torch.float32, "bf16": torch.bfloat16,
          "bfloat16": torch.bfloat16}
TINY_CHANNELS = 32  # model_channels of the --tiny UNet and autoencoder
TINY_CLASSIFIER = {"model_channels": 16, "out_channels": 32}  # the --tiny classifier encoder
TINY_DIT = {"hidden_size": 96, "depth": 2, "num_heads": 4}  # the --tiny DiT: heads of 24
NETWORKS = {"unet": UNet, "dit": DiT}


@dataclasses.dataclass
class Recipe:
    name: str
    config_cls: type
    dims: int
    epochs: int
    batch: int
    kind: str = "edm"  # edm | autoencoder | classifier | consistency | distill | ddpm
    latent: bool = False
    ae_name: str | None = None  # a latent recipe's frozen autoencoder run
    optimizer: str = "adam"
    weight_decay: float = 0.0
    ema_decay: float = 0.999
    network: str = "unet"  # the denoiser: unet | dit (the hparams.json key of its widths)


def _autoencoder(name, config_cls, dims, epochs, batch):
    return Recipe(name, config_cls, dims, epochs, batch, "autoencoder", optimizer="adamw",
                  weight_decay=1e-4, ema_decay=0.0)


RECIPES = {
    "1d_edm": Recipe("EDM-MovingAvg", configs.MovingAverageEnvelopeConfig, 1, 200, 256),
    "1d_autoencoder": _autoencoder("Autoencoder-1024x16-MovingAvg",
                                   configs.LatentMovingAverageEnvelopeConfig, 1, 200, 256),
    "1d_latent_edm": Recipe("Latent-EDM-MovingAvg-1024x16",
                            configs.LatentMovingAverageEnvelopeConfig, 1, 300, 256, latent=True,
                            ae_name="Autoencoder-1024x16-MovingAvg"),
    "autoencoder": _autoencoder(AE_NAME, configs.LatentSpectrogramConfig, 2, 300, 128),
    "edm": Recipe("EDM-128x128-LogSpectrogram", configs.SpectrogramConfig, 2, 300, 64),
    "latent_edm": Recipe(RUN_NAME, configs.LatentSpectrogramConfig, 2, 200, 256, latent=True,
                         ae_name=AE_NAME),
    "latent_dit": Recipe("Latent-DiT-XL2-32x32x8-LogSpectrogram", configs.LatentSpectrogramConfig,
                         2, 200, 256, latent=True, ae_name=AE_NAME, network="dit"),
    "classifier": Recipe("Classifier-LogSpectrogram", configs.SpectrogramClassificationConfig, 2,
                         110, 64, "classifier", ema_decay=0.0),
    "consistency": Recipe("Consistency-MovingAvg", configs.MovingAverageEnvelopeConfig, 1, 200,
                          256, "consistency", optimizer="radam"),
    "latent_consistency": Recipe("Latent-Consistency-32x32x8-LogSpectrogram",
                                 configs.LatentSpectrogramConfig, 2, 200, 256, "consistency",
                                 latent=True, ae_name=AE_NAME, optimizer="radam"),
    # the EMA is the CD target network (decay mu, the train CLI's --ema-decay)
    "latent_distill": Recipe("Latent-Distill-32x32x8-LogSpectrogram",
                             configs.LatentSpectrogramConfig, 2, 80, 256, "distill", latent=True,
                             ae_name=AE_NAME, optimizer="radam", ema_decay=0.95),
    "ddpm": Recipe("DDPM-MovingAvg", configs.MovingAverageEnvelopeConfig, 1, 200, 256, "ddpm",
                   optimizer="adamw"),
}
SAMPLED_KINDS = ("edm", "consistency", "distill", "ddpm")
FEW_EVAL = ("consistency", "latent_consistency", "latent_distill")  # 2 network evals by default
CONSISTENCY_NOISE = ("auto", "song", "reference")


def parse_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def load_weights(module: torch.nn.Module, weights, seed: int) -> torch.nn.Module:
    """Load a ``.pt`` state dict, or fill seeded random weights when None."""
    if weights is None:
        return randomize_(module, seed)
    module.load_state_dict(torch.load(weights, map_location="cpu", weights_only=True))
    return module


def tuplify(cfg: dict) -> dict:
    """A module config read back from JSON, with its lists as tuples again."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}


def build_autoencoder(config, dtype=None, *, dims: int = 2, tiny: bool = False, **overrides):
    """The 1D or 2D autoencoder preset computing in ``dtype`` over f32
    parameters (None: in its weights' dtype), with ``overrides`` (e.g.
    ``conv_resample``) set in both the encoder's and the decoder's config;
    returns (module, encoder config, decoder config)."""
    get = configs.get_1d_autoencoder_configs if dims == 1 else configs.get_2d_autoencoder_configs
    enc_cfg, dec_cfg = get(config)
    if tiny:
        overrides = {"model_channels": TINY_CHANNELS} | overrides
    enc_cfg, dec_cfg = enc_cfg | overrides, dec_cfg | overrides
    return set_compute_dtype(AutoencoderKL(enc_cfg, dec_cfg), dtype), enc_cfg, dec_cfg


def autoencoder_hparams(config, enc_cfg: dict, dec_cfg: dict) -> dict:
    """What an autoencoder run stores in ``hparams.json`` (the JAX keys)."""
    return {"kind": "autoencoder", "dims": enc_cfg.get("dims"), "encoder": enc_cfg,
            "decoder": dec_cfg, "kl_weight": config.kl_weight}


def run_checkpoint(config, run_name: str, provenance: dict | None = None) -> tuple[dict, dict]:
    """(the EMA weights of the newest checkpoint, the stored hyperparameters)
    of the port's run ``outputs/<run_name>``; SystemExit when the run has no
    checkpoint or no ``hparams.json``.  ``provenance``: receives the
    checkpoint's step and the run's ``progress.json`` (as ``train_*``, or
    under ``progress_mismatch`` when it records another step: a training
    process saved since)."""
    ckpt = Checkpointer(Path(config.outputdir) / run_name / "checkpoints")
    restored = ckpt.restore_latest_raw()
    stored = ckpt.restore_hyperparameters()
    if restored is None or stored is None:
        raise SystemExit(f"no checkpoint with its hparams.json under {ckpt.directory} (train its "
                         f"recipe with `python -m tqdne_tpu_torch.cli.train <recipe> --workdir "
                         f"...`, import one with tqdne_tpu_torch.cli.import_checkpoint, or pass "
                         f"the weights file)")
    logger.info("loaded %s (EMA weights, step %d) from %s", run_name, restored[1], ckpt.directory)
    if provenance is not None:
        provenance["checkpoint_step"] = int(restored[1])
        progress = ckpt.directory / "progress.json"
        if progress.exists():
            prog = {f"train_{k}": v for k, v in json.loads(progress.read_text()).items()}
            if prog.get("train_step") == int(restored[1]):
                provenance.update(prog)
            else:
                provenance["progress_mismatch"] = prog
    return restored[0]["ema"], stored


def frozen_autoencoder(config, dtype=None, *, dims: int = 2, tiny: bool = False, weights=None,
                       ae_name: str = AE_NAME):
    """A latent recipe's frozen autoencoder at the preset widths, from the
    ``.pt`` state dict ``weights``, or without one from the port's run
    ``ae_name``: its newest checkpoint's EMA weights, as the JAX
    ``load_ae_variables`` (stored hyperparameters that differ are reported,
    and an architecture that differs then fails to load).  Returns (module,
    encoder config, decoder config) as ``build_autoencoder``."""
    ae, enc_cfg, dec_cfg = build_autoencoder(config, dtype, dims=dims, tiny=tiny)
    if weights is not None:
        return load_weights(ae, weights, 0), enc_cfg, dec_cfg
    state, stored = run_checkpoint(config, ae_name)
    diffs = hparams_diff(stored, autoencoder_hparams(config, enc_cfg, dec_cfg))
    if diffs:
        logger.warning("%s stores other hyperparameters than the preset: %s", ae_name,
                       "; ".join(diffs[:8]))
    ae.load_state_dict(state)
    return ae, enc_cfg, dec_cfg


def build_unet(config, in_channels: int, out_channels: int, dtype=None, *, dims: int = 2,
               **overrides):
    """The 1D or 2D UNet preset computing in ``dtype`` over f32 parameters
    (None: in its weights' dtype); returns (module, its config)."""
    get = configs.get_1d_unet_config if dims == 1 else configs.get_2d_unet_config
    ucfg = get(config, in_channels, out_channels) | overrides
    return set_compute_dtype(UNet(**ucfg), dtype), ucfg


def build_network(recipe: Recipe, config, channels: int, dtype=None, *, tiny: bool = False,
                  **overrides):
    """The recipe's denoiser preset over ``channels`` in and out (the UNet's
    ``build_unet``, or the DiT's ``configs.get_dit_config``), computing in
    ``dtype`` over f32 parameters, at the ``--tiny`` widths when ``tiny``;
    returns (module, its config)."""
    if recipe.network == "dit":
        cfg = configs.get_dit_config(config, channels) | (TINY_DIT if tiny else {}) | overrides
        return set_compute_dtype(DiT(**cfg), dtype), cfg
    tiny_over = {"model_channels": TINY_CHANNELS} if tiny else {}
    return build_unet(config, channels, channels, dtype, dims=recipe.dims,
                      **tiny_over | overrides)


def stored_network(recipe: Recipe, hparams: dict) -> torch.nn.Module:
    """The recipe's denoiser at the widths ``hparams`` stores under its
    ``network`` key (a run's ``hparams.json``, an artifact's manifest)."""
    if recipe.network not in hparams:
        raise SystemExit(f"the stored hyperparameters hold no {recipe.network!r} widths (keys: "
                         f"{', '.join(sorted(hparams))})")
    return NETWORKS[recipe.network](**tuplify(hparams[recipe.network]))


def refuse_options(recipe_key: str, *, int8: bool = False, spatial: int = 0) -> None:
    """SystemExit for ``--int8`` or ``--spatial`` on a recipe whose denoiser is
    not the UNet: the int8 mode quantizes convolutions and the spatial split
    exchanges convolution halos and GroupNorm statistics, and the DiT has
    neither."""
    recipe = RECIPES.get(recipe_key)
    if recipe is None or recipe.network == "unet":
        return
    for flag, on in (("--int8", int8), ("--spatial", spatial > 1)):
        if on:
            raise SystemExit(f"{flag} does not apply to recipe {recipe_key!r}: its "
                             f"{recipe.network} has no convolutions or GroupNorms to quantize "
                             "or split")


def signal_shape(config) -> tuple[int, ...]:
    """Channels-last shape of one example's representation of a 3-component
    waveform: (F, frames, C) for a spectrogram, (T, C) for the envelope."""
    sig = config.make_representation().get_representation(torch.zeros(1, 3, config.t))
    return tuple(sig.movedim(1, -1).shape[1:])


def latent_shape(enc_cfg: dict, sig_shape: tuple[int, ...]) -> tuple[int, ...]:
    """Channels-last latent shape (the JAX ``infer_latent_shape``): one
    stride-2 convolution (rounding up) or, without ``conv_resample``, one
    2-wide average pool (rounding down) per extra level."""
    factor = 2 ** (len(enc_cfg["channel_mult"]) - 1)
    if enc_cfg.get("conv_resample", True):
        return (*(-(-s // factor) for s in sig_shape[:-1]), enc_cfg["out_channels"] // 2)
    return (*(s // factor for s in sig_shape[:-1]), enc_cfg["out_channels"] // 2)


def ensure_dataset(config, synthetic_n: int | None):
    """Create a synthetic dataset if asked and no real one exists: on rank 0
    alone, every rank waiting until it is written."""
    exists = Path(config.datapath).exists()
    barrier()  # every rank has looked before rank 0 writes
    if exists:
        return
    if not synthetic_n:
        raise FileNotFoundError(
            f"dataset not found: {config.datapath}. Build it with `python -m "
            "tqdne_tpu_torch.cli.build_dataset --workdir ...` (from the raw_waveforms.h5 "
            "of cli.preprocess or cli.build_stead), or pass --synthetic N for a smoke run.")
    if rank() == 0:
        logger.warning("no dataset at %s: generating synthetic data (n=%d)", config.datapath,
                       synthetic_n)
        make_synthetic_dataset(config.datapath, n=synthetic_n, t=config.t)
    barrier()


def val_batch_size(batch_size: int, n_val: int) -> int:
    """The validation batch (the JAX ``make_loaders``' rule): the training
    batch, at most the split's rows rounded down to a multiple of the ranks,
    and at least one row a rank."""
    n = world_size()
    return max(n, min(batch_size, (n_val // n) * n or n))


def make_loaders(config, batch_size: int, *, cond: bool, device, val_batch: int | None = None,
                 keys=("signal", "cond"), val_keys=None, host_representation: bool = True,
                 latents_path=None):
    """Train and validation loaders over the HDF5 dataset; returns (train,
    validation, representation).  ``val_keys``: the validation batches'
    columns (default ``keys``), e.g. with the ``waveform`` targets of the
    sampling-eval callback.

    ``host_representation=False``: the datasets ship raw waveforms (the
    step computes the signal on the device); the representation returned
    is still the real one.  ``latents_path``: ``CachedLatentsDataset`` over
    the precomputed moments, whose training columns go to the device once
    (``DeviceResidentLoader``) when they fit, which is never above one rank.
    ``batch_size`` is the global batch."""
    representation = config.make_representation()
    ds_rep = representation if host_representation else Identity()

    def make_ds(split):
        if latents_path is not None:
            return CachedLatentsDataset(config.datapath, latents_path, ds_rep, cut=config.t,
                                        cond=cond, split=split)
        return Dataset(config.datapath, ds_rep, cut=config.t, cond=cond, split=split)

    ds_train, ds_val = make_ds("train"), make_ds("validation")
    vb = val_batch or val_batch_size(batch_size, len(ds_val))
    if latents_path is not None and DeviceResidentLoader.fits(ds_train, keys):
        train_loader = DeviceResidentLoader(ds_train, batch_size, device=device, keys=keys)
    else:
        train_loader = BatchLoader(ds_train, batch_size, device=device, keys=keys)
    val_loader = BatchLoader(ds_val, vb, shuffle=False, drop_last=True, device=device,
                             keys=val_keys or keys)
    return train_loader, val_loader, representation


def add_common_args(parser):
    """The flags of ``tqdne_tpu.cli.common.add_common_args`` the train CLI
    reads, plus ``--device``, ``--ae-weights`` and ``--dropout``."""
    parser.add_argument("--workdir", type=str, required=True,
                        help="working directory (data/ and outputs/ live here)")
    parser.add_argument("-b", "--batchsize", type=int, default=None,
                        help="the global batch (split across the ranks)")
    parser.add_argument("-d", "--num-devices", type=int, default=None,
                        help="devices to use, one rank each (default: torchrun's WORLD_SIZE, "
                             "else 1); without torchrun, N > 1 starts N local ranks")
    parser.add_argument("--num-slices", type=int, default=None,
                        help="multi-node runs: train over a (replica, data) mesh with this "
                             "many slices of consecutive ranks, e.g. one per node (default: "
                             "1 = flat mesh)")
    parser.add_argument("--max-epochs", type=int, default=None)
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--dtype", type=str, default="bf16", choices=["f32", "bf16"],
                        help="compute dtype (parameters are always f32)")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="if no dataset exists, generate a synthetic one with N examples")
    parser.add_argument("--ae-weights", type=str, default=None,
                        help="latent recipes: the frozen autoencoder's state dict (.pt, e.g. "
                             "from tqdne_tpu_torch.utils.convert); default: the port's own "
                             "autoencoder run in the workdir")
    parser.add_argument("--no-resume", action="store_true")
    parser.add_argument("--eval-every", type=int, default=10,
                        help="sampling-eval callback period in epochs (the diffusion recipes)")
    parser.add_argument("--val-every", type=int, default=1,
                        help="validation-loss pass period in epochs")
    parser.add_argument("--checkpoint-every", type=int, default=1,
                        help="checkpoint period in epochs")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tiny", action="store_true",
                        help="shrink model widths for smoke runs (32-channel UNet and AE, "
                             "16-channel classifier)")
    parser.add_argument("--cached-latents", action="store_true",
                        help="latent recipes: read the autoencoder's precomputed moments "
                             "(tqdne_tpu_torch.cli.precompute_latents) instead of encoding "
                             "every step")
    parser.add_argument("--device-representation", action="store_true",
                        help="compute the signal representation on the device inside the "
                             "train step (the loader ships raw waveforms)")
    parser.add_argument("--dropout", type=float, default=None,
                        help="the models' dropout rate (default: the preset's); dropout masks "
                             "are drawn on each rank, so at 0 an N-device run computes what "
                             "one device computes at the same global batch")
    parser.add_argument("--skip-nonfinite", type=int, default=0, metavar="N",
                        help="apply no update for a step with NaN/inf gradients, and accept "
                             "the update after N consecutive such steps, as optax "
                             "apply_if_finite (0 = off)")
    return parser


class InferenceBundle:
    """A sampleable recipe: the denoiser (``unet``: the UNet, or the DiT of
    ``latent_dit``), the frozen autoencoder of a latent
    recipe (None otherwise), the representation that turns the sampled
    signal into waveforms, and the sampler of the recipe's ``kind``: the EDM
    ODE (``solver``, ``num_steps`` as its steps), few-eval consistency
    sampling (``num_steps`` network evals: one from sigma_max, then
    ``num_steps - 1`` refinements at ``refine_sigma`` in the
    ``consistency_noise`` convention; the raw parameterisation for
    ``consistency``, the EDM-conditioned one for ``distill``) or DDPM's
    ``ddpm_cfg.num_train_timesteps`` ancestral steps.  ``int8``: the sampler's
    convolutions (the UNet's and the decoder's) run in the int8 mode
    (``nn.quant``); ``mesh``: the EDM sampler runs spatially partitioned over
    it (``parallel.spatial``), and every rank gets the whole batch back."""

    def __init__(self, config, representation, unet, autoencoder, sig_shape, model_shape, *,
                 num_steps: int, solver: str, device: torch.device, kind: str = "edm",
                 consistency_noise: str = "auto", refine_sigma: float = 1.0,
                 int8: bool = False, mesh=None):
        self.config = config
        self.representation = representation
        self.unet = unet
        self.autoencoder = autoencoder
        self.sig_shape = sig_shape  # channels-last signal shape, no batch
        self.model_shape = model_shape  # channels-last latent (or signal) shape, no batch
        self.num_steps = num_steps
        self.solver = solver
        self.device = device
        self.kind = kind
        self.consistency_noise = consistency_noise
        self.refine_sigma = refine_sigma
        self.ddpm_cfg = ddpm_lib.DDPMConfig()
        self.int8 = int8
        self.mesh = mesh
        self.provenance = {}  # which weights: run, step, checkpoint or artifact (build_inference)

    @property
    def t(self) -> int:
        return self.config.t

    def sample(self, cond: torch.Tensor, *, noise=None, generator=None) -> torch.Tensor:
        """Normalised conditioning (B, 5) -> the channels-last signal
        (B, *sig_shape), decoded for a latent recipe, f32.  ``noise``: the
        sampler's initial standard-normal draw of the model shape; it and
        every later draw come from ``generator`` otherwise."""
        cond = cond.to(self.device, torch.float32)
        shape = (cond.shape[0], *self.model_shape)
        kw = dict(generator=generator, device=self.device)
        with span("sample"), int8_scope() if self.int8 else contextlib.nullcontext():
            if self.kind == "ddpm":
                return ddpm_lib.ddpm_sample(self.ddpm_cfg, self.unet, shape, cond=cond, x=noise,
                                            **kw)
            kw["autoencoder"] = self.autoencoder
            if self.kind == "edm":
                return sample_edm(self.unet, shape, cond, num_steps=self.num_steps,
                                  solver=self.solver, noise=noise, mesh=self.mesh, **kw)
            sample = sample_consistency if self.kind == "consistency" else sample_distilled
            return sample(self.unet, shape, cond,
                          sigmas=(self.refine_sigma,) * (self.num_steps - 1),
                          noise=self.consistency_noise, eps=noise, **kw)

    def generate(self, cond: torch.Tensor, *, noise=None, init_phase=None,
                 generator=None) -> torch.Tensor:
        """Normalised conditioning (B, 5) -> waveforms (B, 3, t), f32."""
        with span("generate"):
            signal = self.sample(cond, noise=noise, generator=generator)
            # a spatial sampler gives every rank the whole batch, which it inverts as one process
            with whole_batch() if self.mesh is not None else contextlib.nullcontext():
                return self.invert(signal, init_phase=init_phase, generator=generator)

    def invert(self, signal: torch.Tensor, *, init_phase=None, generator=None) -> torch.Tensor:
        """Channels-last signal (B, *sig_shape) -> waveforms (B, 3, t) on the
        signal's device: Griffin-Lim for a spectrogram (``init_phase`` or
        ``generator`` seeds it), the elementwise inverse for the envelope."""
        with span("invert"):
            wave = invert(self.representation, signal.movedim(-1, 1), init_phase=init_phase,
                          generator=generator)
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
def build_inference(recipe_key: str = "latent_edm", *, workdir=None, unet_weights=None,
                    ae_weights=None, run_name: str | None = None, ae_name: str | None = None,
                    edm_checkpoint=None, autoencoder_checkpoint=None, exported_weights=None,
                    dtype=torch.bfloat16, num_steps: int = 25, solver: str = "heun",
                    gl_iters: int | None = None, device="cuda", tiny: bool = False,
                    init_seed: int = 0, consistency_noise: str = "auto",
                    refine_sigma: float = 1.0, int8: bool = False,
                    spatial: int = 0) -> InferenceBundle:
    """Build the sampler of a diffusion recipe on ``device`` (``cuda``
    unless asked): an EDM recipe (``latent_edm``, ``latent_dit``, ``edm``,
    ``1d_edm``, ``1d_latent_edm``; ``solver`` heun or dpmpp_2m), a consistency recipe
    (``consistency``, ``latent_consistency``), the distilled student
    (``latent_distill``) or ``ddpm``.  ``num_steps`` counts the EDM ODE's
    steps, or the network evals of the few-eval samplers, whose refinement
    passes run at ``refine_sigma`` in the ``consistency_noise`` convention
    (``auto``, ``song`` or ``reference``); DDPM runs its 1000 steps.

    The denoiser (the recipe's ``network``) takes its weights from the first
    of: its ``.pt`` state dict (``unet_weights``); a reference Lightning
    checkpoint converted on the fly (``edm_checkpoint``, its EMA weights where
    it holds them; UNets only); an exported artifact (``exported_weights``,
    ``cli.export_weights``: digest-checked against its manifest, the network
    built at the manifest's widths); the port's run ``run_name`` (default: the
    recipe's) in ``workdir``, its newest checkpoint's EMA weights, the model
    rebuilt at the widths its ``hparams.json`` stores, as the JAX
    ``build_inference`` rebuilds it; and, without a workdir, seeded random
    weights (``init_seed``) at the preset.
    A latent recipe's autoencoder likewise: ``ae_weights``,
    ``autoencoder_checkpoint``, the run ``ae_name`` (default: the recipe's),
    random.  ``bundle.provenance`` records the source (``run_name``,
    ``recipe``, and ``checkpoint_step`` with the run's progress,
    ``torch_checkpoint``, or ``exported_weights`` with its step and
    ``weights_sha256``).
    ``dtype``: compute dtype; bf16 casts the bundle's UNet parameters once
    (the JAX ``cast_params``) and runs the autoencoder's convolutions in bf16.
    ``tiny``: 32-channel presets (the JAX ``--tiny`` widths; ``TINY_DIT``).  ``gl_iters``
    is refused by a recipe that has no Griffin-Lim.
    ``int8``: the sampler's convolutions run in the int8 mode (``nn.quant``;
    the caller's other models, a classifier, keep theirs).  ``spatial`` K > 1:
    an EDM recipe samples each batch split K ways along its first spatial axis
    over a ``("data", "model")`` mesh of the launched ranks
    (``parallel.spatial``), the weights replicated from rank 0; at most 1
    changes nothing.  Neither applies to ``latent_dit`` (``refuse_options``).
    """
    if recipe_key not in RECIPES:
        raise SystemExit(f"unknown recipe {recipe_key!r} (have: {', '.join(RECIPES)})")
    refuse_options(recipe_key, int8=int8, spatial=spatial)
    recipe = RECIPES[recipe_key]
    if recipe.kind not in SAMPLED_KINDS:
        raise SystemExit(f"recipe {recipe_key!r} has no sampler (kind={recipe.kind})")
    if recipe.kind == "edm" and solver not in ("heun", "dpmpp_2m"):
        raise SystemExit(f"unknown solver {solver!r} for an EDM recipe; use 'heun' or "
                         "'dpmpp_2m'")
    if spatial > 1 and recipe.kind != "edm":
        raise SystemExit(f"--spatial serves EDM recipes only (got {recipe.kind})")
    if spatial > 1 and world_size() % spatial:
        raise SystemExit(f"--spatial {spatial} needs a multiple of {spatial} ranks, not "
                         f"{world_size()} (launch them with torchrun, or let the CLI start "
                         f"them)")
    if consistency_noise not in CONSISTENCY_NOISE:
        raise SystemExit(f"unknown consistency noise {consistency_noise!r}; use one of "
                         f"{', '.join(CONSISTENCY_NOISE)}")
    if recipe.kind in ("consistency", "distill") and num_steps < 1:
        raise SystemExit(f"num_steps {num_steps}: a few-eval sampler takes at least one eval")
    device = resolve_device(device)
    config = recipe.config_cls(workdir=workdir or ".")
    if gl_iters is not None:
        if not hasattr(config, "griffin_lim_iters"):
            raise SystemExit(f"recipe {recipe_key!r} has no Griffin-Lim inversion")
        config.griffin_lim_iters = gl_iters
    representation = config.make_representation()
    sig_shape = model_shape = signal_shape(config)
    provenance = {"run_name": run_name or recipe.name, "recipe": recipe_key}

    autoencoder = None
    if recipe.latent:
        if ae_weights is None and autoencoder_checkpoint is None and workdir is not None:
            state, stored = run_checkpoint(config, ae_name or recipe.ae_name)
            enc_cfg = tuplify(stored["encoder"])
            autoencoder = set_compute_dtype(
                AutoencoderKL(enc_cfg, tuplify(stored["decoder"])), dtype)
            autoencoder.load_state_dict(state)
        else:
            autoencoder, enc_cfg, dec_cfg = build_autoencoder(config, dtype, dims=recipe.dims,
                                                              tiny=tiny)
            if autoencoder_checkpoint is not None:
                sd, _ = load_lightning_checkpoint(autoencoder_checkpoint, prefix="", ema=True)
                autoencoder.load_state_dict(convert_autoencoder(sd, enc_cfg, dec_cfg))
            else:
                load_weights(autoencoder, ae_weights, init_seed + 1)
        model_shape = latent_shape(enc_cfg, sig_shape)

    if unet_weights is edm_checkpoint is exported_weights is None and workdir is not None:
        state, stored = run_checkpoint(config, run_name or recipe.name, provenance)
        unet = stored_network(recipe, stored)
        unet.load_state_dict(state)
    else:
        unet, ucfg = build_network(recipe, config, model_shape[-1], tiny=tiny)
        if unet_weights is not None or edm_checkpoint is None and exported_weights is None:
            load_weights(unet, unet_weights, init_seed)
        elif edm_checkpoint is not None:
            if recipe.network != "unet":
                raise SystemExit(f"a reference Lightning checkpoint holds a UNet; recipe "
                                 f"{recipe_key!r} samples a {recipe.network}")
            sd, _ = load_lightning_checkpoint(edm_checkpoint, prefix="unet", ema=True)
            unet.load_state_dict(convert_unet(sd, ucfg))
            provenance["torch_checkpoint"] = str(edm_checkpoint)
        else:
            from tqdne_tpu_torch.cli.export_weights import load_exported

            params, manifest = load_exported(exported_weights)
            provenance["exported_weights"] = str(exported_weights)
            if manifest is not None:
                provenance["checkpoint_step"] = manifest.get("checkpoint_step")
                provenance["weights_sha256"] = manifest.get("sha256")
                if recipe.network in manifest.get("hparams", {}):  # the artifact's own widths
                    unet = stored_network(recipe, manifest["hparams"])
            unet.load_state_dict(flax_to_state_dict(params))
    if dtype == torch.bfloat16:
        unet.to(dtype)  # the bundle's own UNet: its parameters are cast once
    mesh = spatial_mesh(spatial) if spatial > 1 else None
    for module in (unet, autoencoder):
        if module is not None:
            module.to(device).eval()
            if device.type == "cuda":
                module.to(memory_format=torch.channels_last)
            if mesh is not None:
                replicate_(module)
    bundle = InferenceBundle(config, representation, unet, autoencoder, sig_shape, model_shape,
                             num_steps=num_steps, solver=solver, device=device,
                             kind=recipe.kind, consistency_noise=consistency_noise,
                             refine_sigma=refine_sigma, int8=int8, mesh=mesh)
    bundle.provenance = provenance
    return bundle


def route_solver(config: str, solver: str, num_steps: int | None) -> tuple[str, int]:
    """The JAX generate and serve CLIs' routing of ``--solver``: consistency
    and distill sample a trained few-eval run, so with the flagship's
    ``latent_edm`` they take its ``latent_consistency`` / ``latent_distill``
    counterpart, and any other EDM ``--config`` is refused.  ``num_steps``
    defaults to 2 network evals for the few-eval recipes, 25 otherwise.
    Returns (recipe, num_steps)."""
    if solver == "consistency" and config == "latent_edm":
        config = "latent_consistency"
    if solver == "distill" and config == "latent_edm":
        config = "latent_distill"
    if solver == "consistency" and config not in ("consistency", "latent_consistency"):
        raise SystemExit("--solver consistency samples a consistency-model run; use it with "
                         "--config consistency / latent_consistency (or omit --config)")
    if solver == "distill" and config != "latent_distill":
        raise SystemExit("--solver distill samples a distilled-consistency run; use it with "
                         "--config latent_distill (or omit --config)")
    if num_steps is None:
        num_steps = 2 if config in FEW_EVAL else 25
    return config, num_steps


def dataset_feature_stats(config) -> np.ndarray:
    """(5, 2) [mean, std] of the raw conditioning features of the dataset:
    the normalisation derived from data instead of the published table."""
    import h5py

    with h5py.File(config.datapath, "r", locking=False) as f:
        columns = [f[key][:] for key in config.features_keys]
    return np.array([[float(c.mean()), float(c.std())] for c in columns])


def run_ranks(fn, args, n: int):
    """``fn(args)``, returning its result, in this process when torchrun started it
    (its group joined on the process's card) or ``n`` is at most 1; else on ``n``
    local ranks started here over a free loopback port, returning None once they
    end.  The ranks share the visible cards in turn: NCCL where each has a card
    of its own, gloo where they share one (NCCL cannot put two ranks on one card)
    or on the CPU."""
    if n <= 1:
        return fn(args)
    if "WORLD_SIZE" in os.environ:
        from tqdne_tpu_torch.parallel import process_group

        with process_group(args.device):
            return fn(args)
    with socket.socket() as s:  # a free port for the ranks' rendezvous
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.multiprocessing.spawn(_spawned_rank, args=(fn, args, n, port), nprocs=n, join=True)
    return None


def _spawned_rank(local_rank: int, fn, args, n: int, port: int):
    """One of ``run_ranks``' local ranks: torchrun's environment, its card, its group."""
    import torch.distributed as dist

    os.environ.update(RANK=str(local_rank), LOCAL_RANK=str(local_rank), WORLD_SIZE=str(n),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    backend = "gloo"
    if torch.device(args.device).type == "cuda":
        cards = torch.cuda.device_count()
        torch.cuda.set_device(local_rank % cards)
        backend = "nccl" if n <= cards else "gloo"
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, min(torch.get_num_threads(), (os.cpu_count() or 1) // n)))
    dist.init_process_group(backend, init_method="env://")
    try:
        fn(args)
    finally:
        dist.destroy_process_group()


def rank_device(device) -> torch.device:
    """The device this rank drives: its current card for ``cuda`` (``run_ranks``
    and torchrun's launches set it), the CPU as given."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
