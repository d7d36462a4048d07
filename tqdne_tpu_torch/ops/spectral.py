"""STFT / iSTFT / Griffin-Lim in ``torch.fft``: the port of
``tqdne_tpu/ops/spectral.py`` (its ``fft`` branch).

Centered frames with **zero** padding (``torch.stft(center=True)`` would pad
by reflection), a periodic Hann window, and a NOLA-normalised overlap-add
inverse with a 1e-10 guard.  Everything runs on the tensor's device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tqdne_tpu_torch.parallel import draw_rows


def hann_window(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * torch.arange(n, dtype=dtype, device=device) / n)


def _stft_fm(x, n_fft: int, hop: int):
    """Frames-major STFT: (..., T) -> (..., n_frames, n_fft//2+1) complex."""
    xp = F.pad(x, (n_fft // 2, n_fft // 2))
    frames = xp.unfold(-1, n_fft, hop)  # (..., n_frames, n_fft)
    return torch.fft.rfft(frames * hann_window(n_fft, x.dtype, x.device), dim=-1)


def stft(x, n_fft: int, hop: int):
    """Centered STFT of the last axis: (..., T) -> (..., n_fft//2+1, n_frames)."""
    return _stft_fm(x, n_fft, hop).transpose(-1, -2)


def _overlap_add(frames, hop: int, size: int):
    """(N, n_frames, n_fft) -> (N, size) sum of frames placed every ``hop``."""
    n, _, n_fft = frames.shape
    out = F.fold(frames.transpose(1, 2), output_size=(1, size), kernel_size=(1, n_fft),
                 stride=(1, hop))
    return out.reshape(n, size)


def _istft_fm(spec_t, n_fft: int, hop: int, length: int):
    """Frames-major inverse STFT: (..., n_frames, bins) -> (..., length)."""
    lead, n_frames = spec_t.shape[:-2], spec_t.shape[-2]
    frames = torch.fft.irfft(spec_t, n=n_fft, dim=-1)
    win = hann_window(n_fft, frames.dtype, frames.device)
    size = hop * (n_frames - 1) + n_fft
    out = _overlap_add((frames * win).reshape(-1, n_frames, n_fft), hop, size)
    norm = _overlap_add((win**2).expand(1, n_frames, n_fft), hop, size)[0]
    norm = torch.where(norm > 1e-10, norm, torch.ones_like(norm))
    out = out / norm
    need = n_fft // 2 + length
    if size < need:  # frames end before the requested length: zeros, as in the JAX fold
        out = F.pad(out, (0, need - size))
    return out[:, n_fft // 2 : need].reshape(*lead, length)


def istft(spec, n_fft: int, hop: int, length: int):
    """NOLA-normalised inverse STFT: (..., n_fft//2+1, n_frames) -> (..., length)."""
    return _istft_fm(spec.transpose(-1, -2), n_fft, hop, length)


def griffin_lim(mag, n_fft: int, hop: int, length: int, *, n_iter: int = 128,
                momentum: float = 0.99, init_phase=None,
                generator: torch.Generator | None = None):
    """Batched momentum Griffin-Lim on ``mag``'s device.

    ``mag`` is (..., n_fft//2+1, n_frames).  ``init_phase`` (radians, mag's
    shape) sets the starting phase; when None it is 2 pi U[0, 1) drawn from
    ``generator``, the JAX package's convention.
    """
    if init_phase is None:
        init_phase = 2.0 * math.pi * draw_rows(torch.rand, mag.shape, generator=generator,
                                               dtype=torch.float32, device=mag.device)
    mag_fm = mag.transpose(-1, -2)
    phase = init_phase.transpose(-1, -2)
    angles = torch.complex(torch.cos(phase), torch.sin(phase))
    rebuilt_prev = torch.zeros_like(angles)
    beta = momentum / (1 + momentum)
    for _ in range(n_iter):
        rebuilt = _stft_fm(_istft_fm(mag_fm * angles, n_fft, hop, length), n_fft, hop)
        angles = rebuilt - beta * rebuilt_prev
        angles = angles / (angles.abs() + 1e-16)
        rebuilt_prev = rebuilt
    return _istft_fm(mag_fm * angles, n_fft, hop, length)
