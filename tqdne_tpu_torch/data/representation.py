"""Representations: the port of ``LogSpectrogram`` and ``Identity`` in
``tqdne_tpu/data/representation.py``.

Waveforms are (..., C, T) tensors (the storage layout); representations
are (..., C, F, frames) normalised to [-1, 1] with the Nyquist row dropped.
Both directions run on the tensor's device; inversion is Griffin-Lim.
"""

from __future__ import annotations

import math

import torch

from tqdne_tpu_torch.ops import spectral


class Identity:
    """The waveform itself: what a dataset ships when the device computes
    the representation inside the train step."""

    def get_representation(self, waveform: torch.Tensor) -> torch.Tensor:
        return waveform


class LogSpectrogram:
    """Normalised log-magnitude spectrogram with Griffin-Lim inversion."""

    # log-magnitude ceiling: e^20 ~ 5e8 is far beyond any physical magnitude
    # but keeps exp() finite for badly trained model outputs
    log_spec_ceiling: float = 20.0

    def __init__(self, stft_channels: int = 256, hop_size: int | None = None,
                 clip: float = 1e-8, log_max: float = 3.0, n_iter: int = 128,
                 length: int = 4064):
        self.n_fft = stft_channels
        self.hop = hop_size if hop_size is not None else stft_channels // 4
        self.clip = clip
        self.log_clip = math.log(clip)
        self.log_max = log_max
        self.n_iter = n_iter
        self.length = length

    def get_representation(self, waveform: torch.Tensor) -> torch.Tensor:
        spec = spectral.stft(waveform, self.n_fft, self.hop)[..., :-1, :].abs()
        log_spec = torch.log(spec.clamp(min=self.clip))
        norm = (log_spec - self.log_clip) / (self.log_max - self.log_clip)
        return (norm * 2 - 1).float()

    def invert_representation(self, representation: torch.Tensor, *, init_phase=None,
                              generator: torch.Generator | None = None) -> torch.Tensor:
        """(..., C, F, frames) -> (..., C, length) waveforms.

        ``init_phase``/``generator`` seed Griffin-Lim (see
        ``ops.spectral.griffin_lim``); the phase has the full spectrum's
        shape, Nyquist row included."""
        norm = (representation.float() + 1) / 2
        log_spec = norm * (self.log_max - self.log_clip) + self.log_clip
        mag = torch.exp(log_spec.clamp(max=self.log_spec_ceiling))
        mag = torch.cat([mag, torch.zeros_like(mag[..., :1, :])], dim=-2)  # re-add Nyquist
        return spectral.griffin_lim(mag, self.n_fft, self.hop, self.length, n_iter=self.n_iter,
                                    init_phase=init_phase, generator=generator)
