"""Configuration and architecture presets of the flagship latent-EDM slice.

The port's own copy of what it needs from ``tqdne_tpu/configs.py``: the
conditioning feature names, the ``LatentSpectrogramConfig`` fields and the
2D UNet / autoencoder presets, with the same values.
"""

from __future__ import annotations

import dataclasses

FEATURES_KEYS = (
    "hypocentral_distance",
    "magnitude",
    "vs30",
    "hypocentre_depth",
    "azimuthal_gap",
)


@dataclasses.dataclass
class LatentSpectrogramConfig:
    """Latent diffusion on 128x128 log-spectrograms: the flagship config."""

    channels: int = 3
    fs: int = 100
    t: int = 4064
    features_keys: tuple[str, ...] = FEATURES_KEYS
    stft_channels: int = 256
    hop_size: int = 32
    griffin_lim_iters: int = 128
    latent_channels: int = 8
    kl_weight: float = 1e-6

    def make_representation(self):
        from tqdne_tpu_torch.data.representation import LogSpectrogram

        return LogSpectrogram(stft_channels=self.stft_channels, hop_size=self.hop_size,
                              n_iter=self.griffin_lim_iters, length=self.t)


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
