"""Configuration and architecture presets of the EDM recipes and the
evaluation classifier.

The port's own copy of what it needs from ``tqdne_tpu/configs.py``: the
conditioning feature names, the ``SpectrogramConfig``,
``LatentSpectrogramConfig``, ``MovingAverageEnvelopeConfig`` and
``LatentMovingAverageEnvelopeConfig`` fields, the magnitude and distance
bins, ``SpectrogramClassificationConfig`` and the 1D and 2D UNet /
autoencoder / classifier-encoder presets, with the same values; and the DiT
preset of the ``latent_dit`` recipe (``get_dit_config``), which the JAX
package has not.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

FEATURES_KEYS = (
    "hypocentral_distance",
    "magnitude",
    "vs30",
    "hypocentre_depth",
    "azimuthal_gap",
)


@dataclasses.dataclass
class Config:
    """Data and outputs live under ``workdir`` as in the JAX ``Config``.
    ``channels`` is the signal's channel count; waveforms always have 3."""

    workdir: str | Path = "."
    channels: int = 3
    fs: int = 100
    t: int = 4064
    features_keys: tuple[str, ...] = FEATURES_KEYS

    def __post_init__(self):
        path = Path(self.workdir)
        self.datasetdir = path / "data"
        self.outputdir = path / "outputs"
        self.datapath = self.datasetdir / "preprocessed_waveforms.h5"
        self.original_datapath = self.datasetdir / "raw_waveforms.h5"


@dataclasses.dataclass
class SpectrogramConfig(Config):
    """128x128 log-spectrograms inverted by Griffin-Lim: the ``edm`` recipe."""

    stft_channels: int = 256
    hop_size: int = 32
    griffin_lim_iters: int = 128

    def make_representation(self):
        from tqdne_tpu_torch.data.representation import LogSpectrogram

        return LogSpectrogram(stft_channels=self.stft_channels, hop_size=self.hop_size,
                              n_iter=self.griffin_lim_iters, length=self.t)


@dataclasses.dataclass
class LatentSpectrogramConfig(SpectrogramConfig):
    """Latent diffusion on 128x128 log-spectrograms: the flagship config."""

    latent_channels: int = 8
    kl_weight: float = 1e-6


@dataclasses.dataclass
class MovingAverageEnvelopeConfig(Config):
    """Raw 1D waveforms with their moving-average envelope: 3 scaled
    channels and 3 log-envelope channels (the ``1d_edm`` recipe)."""

    channels: int = 6

    def make_representation(self):
        from tqdne_tpu_torch.data.representation import MovingAverageEnvelope

        return MovingAverageEnvelope()


@dataclasses.dataclass
class LatentMovingAverageEnvelopeConfig(MovingAverageEnvelopeConfig):
    """The 1D latent chain: ``1d_autoencoder`` and ``1d_latent_edm``."""

    latent_channels: int = 16
    kl_weight: float = 1e-6


# canonical magnitude / distance bins of the classifier and the per-bin report
MAG_BINS: tuple[float, ...] = (4, 4.75, 5, 5.5, 6.5, 7.5, 9.1)
DIST_BINS: tuple[float, ...] = (0, 75, 100, 125, 150, 175, 200)


@dataclasses.dataclass
class SpectrogramClassificationConfig(SpectrogramConfig):
    """Magnitude x distance bin classification on 128x128 log-spectrograms."""

    mag_bins: tuple[float, ...] = MAG_BINS
    dist_bins: tuple[float, ...] = DIST_BINS

    @property
    def num_classes(self) -> int:
        return (len(self.mag_bins) - 1) * (len(self.dist_bins) - 1)


def get_classifier_encoder_config(config, out_channels: int = 256) -> dict:
    return {
        "in_channels": config.channels,
        "model_channels": 64,
        "out_channels": out_channels,
        "channel_mult": (1, 2, 4, 4),
        "attention_resolutions": (8,),
        "num_res_blocks": 2,
        "dims": 2,
        "conv_kernel_size": 3,
        "num_heads": 4,
        "dropout": 0.1,
    }


def get_1d_autoencoder_configs(config) -> tuple[dict, dict]:
    base = {
        "model_channels": 64,
        "channel_mult": (1, 2, 4),
        "attention_resolutions": (),
        "num_res_blocks": 2,
        "dims": 1,
        "conv_kernel_size": 5,
        "dropout": 0.1,
    }
    encoder = base | {"in_channels": config.channels, "out_channels": config.latent_channels * 2}
    decoder = base | {"in_channels": config.latent_channels, "out_channels": config.channels}
    return encoder, decoder


def get_1d_unet_config(config, in_channels: int, out_channels: int) -> dict:
    return {
        "in_channels": in_channels,
        "out_channels": out_channels,
        "cond_features": len(config.features_keys),
        "dims": 1,
        "conv_kernel_size": 5,
        "model_channels": 64,
        "channel_mult": (1, 2, 4, 4),
        "attention_resolutions": (8,),
        "num_res_blocks": 2,
        "num_heads": 4,
        "dropout": 0.1,
    }


def get_2d_autoencoder_configs(config) -> tuple[dict, dict]:
    base = {
        "model_channels": 64,
        "channel_mult": (1, 2, 4),
        "attention_resolutions": (),
        "num_res_blocks": 2,
        "dims": 2,
        "conv_kernel_size": 3,
        "dropout": 0.1,
    }
    encoder = base | {"in_channels": config.channels, "out_channels": config.latent_channels * 2}
    decoder = base | {"in_channels": config.latent_channels, "out_channels": config.channels}
    return encoder, decoder


def get_2d_unet_config(
    config, in_channels: int, out_channels: int, model_channels: int = 128,
    use_causal_mask: bool = False,
) -> dict:
    return {
        "in_channels": in_channels,
        "out_channels": out_channels,
        "cond_features": len(config.features_keys),
        "dims": 2,
        "conv_kernel_size": 3,
        "model_channels": model_channels,
        "channel_mult": (1, 2, 4, 4),
        "attention_resolutions": (8,),
        "num_res_blocks": 2,
        "num_heads": 4,
        "dropout": 0.1,
        "use_causal_mask": use_causal_mask,
    }


def get_dit_config(config, channels: int) -> dict:
    """DiT-XL/2 (arXiv 2212.09748, ``DiT_XL_2``: depth 28, hidden 1152, patch 2,
    16 heads) over the flagship's 8 x 32 x 32 latent: 256 tokens."""
    return {
        "input_size": 32,
        "patch_size": 2,
        "in_channels": channels,
        "out_channels": channels,
        "hidden_size": 1152,
        "depth": 28,
        "num_heads": 16,
        "mlp_ratio": 4.0,
        "frequency_embedding_size": 256,
        "cond_features": len(config.features_keys),
    }
