"""Representations: the port of ``LogSpectrogram``, ``MovingAverageEnvelope``
(with ``moving_average_same``) and ``Identity`` in
``tqdne_tpu/data/representation.py``.

Waveforms are (..., C, T) tensors (the storage layout).  ``LogSpectrogram``
gives (..., C, F, frames) normalised to [-1, 1] with the Nyquist row
dropped, inverted by Griffin-Lim; ``MovingAverageEnvelope`` gives
(..., 2C, T), inverted elementwise.  Both directions run on the tensor's device.
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

    def invert_representation(self, representation: torch.Tensor) -> torch.Tensor:
        return representation


def moving_average_same(x: torch.Tensor, window: int) -> torch.Tensor:
    """Moving average along the last axis in float64, with the window
    placement of ``np.convolve(x, ones(window) / window, mode="same")`` (zero
    padding), as a difference of running sums."""
    x = x.double()
    n = x.shape[-1]
    c = torch.cat([x.new_zeros(*x.shape[:-1], 1), torch.cumsum(x, dim=-1)], dim=-1)
    left = window // 2  # samples strictly before i
    right = window - left - 1  # samples after i
    i = torch.arange(n, device=x.device)
    return (c[..., (i + right + 1).clamp(max=n)] - c[..., (i - left).clamp(min=0)]) / window


class MovingAverageEnvelope:
    """(waveform / envelope, shifted log envelope) stacked on the channel
    axis: 3 waveform channels give 6 signal channels, inverted elementwise
    (as in the JAX package, the inverse restores x (env + 2e-6) / (env +
    1e-6), so it is exact only well above the 1e-6 floors).

    The forward runs in float64 as the JAX host path does: where a waveform
    is quiet, the scaled half divides by an envelope near 1e-6, and a float32
    running sum would cancel there.  The inverse is elementwise, in float32."""

    def __init__(self, window_size: int = 128, log_eps: float = 1e-6, eps: float = 1e-6):
        self.window_size = window_size
        self.log_eps = log_eps
        self.eps = eps

    def get_representation(self, waveform: torch.Tensor) -> torch.Tensor:
        x = waveform.double()
        env = moving_average_same(x.abs(), self.window_size)
        log_env = torch.log(env + self.log_eps) - math.log(self.log_eps) / 2
        return torch.cat([x / (env + self.eps), log_env], dim=-2).float()

    def invert_representation(self, representation: torch.Tensor) -> torch.Tensor:
        """(..., 2C, T) -> (..., C, T) waveforms."""
        scaled, log_env = representation.float().chunk(2, dim=-2)
        return scaled * (torch.exp(log_env + math.log(self.log_eps) / 2) + self.eps)


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


def invert(representation, signal: torch.Tensor, *, init_phase=None,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """Channels-first ``signal`` -> waveforms on its device: Griffin-Lim for
    a spectrogram (``init_phase`` or ``generator`` seeds it), the elementwise
    inverse otherwise."""
    if isinstance(representation, LogSpectrogram):
        return representation.invert_representation(signal, init_phase=init_phase,
                                                    generator=generator)
    return representation.invert_representation(signal)
