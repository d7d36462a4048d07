"""Plain signal representations of the HighFEM recipes, in float32 (float64
where noted).

- The moving-average envelope: a waveform x becomes x / (env + 1e-6) and
  ln(env + 1e-6) - ln(1e-6) / 2, with env the 128-wide moving average of |x|
  placed as ``np.convolve(..., mode="same")`` places it, in float64; the
  inverse multiplies back.
- The normalised log-magnitude spectrogram (256-point periodic-Hann STFT,
  hop 32, frames centred with zero padding, the Nyquist row dropped, logs
  clipped at 1e-8 and mapped from [ln 1e-8, 3] to [-1, 1]) and its inversion
  by momentum Griffin-Lim (momentum 0.99) with a NOLA-normalised overlap-add.

``rnd``, where a function takes it, rounds every intermediate of the
iteration (the benchmark's lower-precision control of the inversion).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LOG_EPS = 1e-6
ENV_EPS = 1e-6
WINDOW = 128
LOG_CLIP, LOG_MAX, CEILING = math.log(1e-8), 3.0, 20.0


def envelope(x):
    """(..., C, T) waveforms -> (..., 2C, T) float32 signal."""
    x = x.double()
    lead, t = x.shape[:-1], x.shape[-1]
    flat = F.pad(x.abs().reshape(-1, 1, t), (WINDOW // 2, WINDOW - WINDOW // 2 - 1))
    ones = torch.full((1, 1, WINDOW), 1.0 / WINDOW, dtype=x.dtype, device=x.device)
    env = F.conv1d(flat, ones).reshape(*lead, t)
    log_env = torch.log(env + LOG_EPS) - math.log(LOG_EPS) / 2
    return torch.cat([x / (env + ENV_EPS), log_env], dim=-2).float()


def envelope_inverse(sig):
    """(..., 2C, T) -> (..., C, T)."""
    scaled, log_env = sig.float().chunk(2, dim=-2)
    return scaled * (torch.exp(log_env + math.log(LOG_EPS) / 2) + ENV_EPS)


def _hann(n, device):
    i = torch.arange(n, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2 * math.pi * i / n)


def stft(x, n_fft: int, hop: int):
    """(N, T) -> (N, frames, n_fft // 2 + 1), frames centred, zero padded."""
    xp = F.pad(x, (n_fft // 2, n_fft // 2))
    idx = torch.arange(0, xp.shape[-1] - n_fft + 1, hop, device=x.device)
    frames = xp[:, idx[:, None] + torch.arange(n_fft, device=x.device)]
    return torch.fft.rfft(frames * _hann(n_fft, x.device), dim=-1)


def istft(spec, n_fft: int, hop: int, length: int):
    """(N, frames, bins) -> (N, length): windowed overlap-add over the summed
    squared window where it exceeds 1e-10."""
    n, frames = spec.shape[:2]
    win = _hann(n_fft, spec.device)
    seg = torch.fft.irfft(spec, n=n_fft, dim=-1) * win
    size = hop * (frames - 1) + n_fft
    pos = (torch.arange(frames, device=spec.device)[:, None] * hop
           + torch.arange(n_fft, device=spec.device)).reshape(-1)
    out = torch.zeros(n, size, device=spec.device).index_add_(1, pos, seg.reshape(n, -1))
    norm = torch.zeros(size, device=spec.device).index_add_(0, pos, (win**2).repeat(frames))
    out = out / torch.where(norm > 1e-10, norm, torch.ones_like(norm))
    need = n_fft // 2 + length
    if size < need:
        out = F.pad(out, (0, need - size))
    return out[:, n_fft // 2:need]


def spectrogram_inverse(sig, init_phase, *, n_fft: int = 256, hop: int = 32,
                        length: int = 4064, n_iter: int = 128, rnd=None):
    """(B, C, F, frames) normalised log-spectrogram -> (B, C, length)
    waveforms, from ``init_phase`` (B, C, F + 1, frames) in radians."""
    b, c = sig.shape[:2]
    log_spec = (sig.float() + 1) / 2 * (LOG_MAX - LOG_CLIP) + LOG_CLIP
    mag = torch.exp(log_spec.clamp(max=CEILING))
    mag = torch.cat([mag, torch.zeros_like(mag[..., :1, :])], dim=-2)
    mag = mag.reshape(b * c, *mag.shape[2:]).transpose(1, 2)  # (N, frames, bins)
    phase = init_phase.reshape(b * c, *init_phase.shape[2:]).transpose(1, 2).float()
    rnd = rnd or (lambda z: z)
    angles = torch.complex(torch.cos(phase), torch.sin(phase))
    prev = torch.zeros_like(angles)
    beta = 0.99 / 1.99
    for _ in range(n_iter):
        rebuilt = rnd(stft(rnd(istft(mag * angles, n_fft, hop, length)), n_fft, hop))
        angles = rebuilt - beta * prev
        angles = rnd(angles / (angles.abs() + 1e-16))
        prev = rebuilt
    return istft(mag * angles, n_fft, hop, length).reshape(b, c, length)
