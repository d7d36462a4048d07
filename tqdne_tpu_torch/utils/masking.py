"""Valid-length masking, channels-last: the port of ``tqdne_tpu/utils/masking.py``.

``indices_valid_waveforms`` marks the last live sample of each record; these
helpers blank everything after it, in waveform space or mapped down into the
latent grid of the flagship autoencoder.
"""

from __future__ import annotations

import torch


def mask_from_indexes(mask_idxs: torch.Tensor, x: torch.Tensor,
                      fill_with: float = float("nan")) -> torch.Tensor:
    """``x`` with ``fill_with`` at and beyond each record's valid index along
    its first spatial axis (time in 1D, the frame axis of a spectrogram):
    ``x`` is (B, T, C) or (B, H, W, C), ``mask_idxs`` (B,)."""
    b, length = x.shape[:2]
    mask = torch.arange(length, device=x.device)[None, :] >= mask_idxs.reshape(b, 1)
    mask = mask.reshape((b, length) + (1,) * (x.ndim - 2))
    return torch.where(mask, torch.tensor(fill_with, dtype=x.dtype, device=x.device), x)


def get_latent_mask_indexes(mask_idxs: torch.Tensor, dim: int = 2):
    """(low, up): the waveform validity indices mapped into the 4x-downsampled
    latent grid, and back up, with the reference's receptive-field offsets."""
    if dim != 2:
        raise ValueError("only dim=2 supported (flagship spectrogram path)")
    low = ((((mask_idxs - 8) / 2) - 8) / 2 - 3).to(torch.int32)
    up = (((low - 6) * 2) - 6) * 2
    return low, up
