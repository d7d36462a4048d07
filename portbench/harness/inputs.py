"""Everything a run feeds the program, made from ``--seed`` on the run's
device: the seeds of each stream, conditioning rows, weights and synthetic
waveforms.  The same seed gives the same inputs; the reference is handed the
same tensors (or makes them again from the same seed)."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

# raw conditioning ranges (hypocentral distance km, magnitude, vs30 m/s, depth km,
# azimuthal gap deg) and the published normalisation (mean, std) of each feature
FEATURE_RANGES = ((10.0, 200.0), (4.5, 7.5), (200.0, 800.0), (2.0, 100.0), (30.0, 330.0))
FEATURE_STATS = ((101.29891904350877, 40.78415968551517), (4.801697862929673, 0.7146698731358634),
                 (384.7045105848187, 220.11269086015872), (38.359214998072, 22.472499592355014),
                 (129.92139043457396, 89.69479051949207))


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for the stream ``path`` of run seed ``seed`` (any integer)."""
    entropy = [seed % 2**64, *(p % 2**64 for p in path)]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> 1)


def generator(device, seed: int, *path: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *path))


@functools.lru_cache(maxsize=None)
def _feature_table(device: str) -> torch.Tensor:
    """(4, 5): the features' low and high ends, means and stds on ``device``,
    copied there once, so that drawing a batch's rows copies nothing from the
    host."""
    return torch.tensor([[r[0] for r in FEATURE_RANGES], [r[1] for r in FEATURE_RANGES],
                         [s[0] for s in FEATURE_STATS], [s[1] for s in FEATURE_STATS]],
                        device=device)


def cond_rows(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """(n, 5) normalised conditioning, raw features uniform over their ranges."""
    lo, hi, mean, std = _feature_table(str(torch.device(device)))
    raw = lo + (hi - lo) * torch.rand((n, 5), generator=gen, device=device)
    return (raw - mean) / std


def init_scale(name: str, shape, fourier_scale: float) -> tuple[float, float]:
    """(offset, std) of a parameter's normal draw: weights std 1/sqrt(fan-in),
    norm scales 1 + 0.1 N, the Fourier frequencies N(0, scale^2), other vectors
    0.05 N (nothing left at zero, so every path computes something)."""
    if name.endswith(".W"):
        return 0.0, fourier_scale
    if len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    if "norm" in name.rsplit(".", 2)[-2] and name.endswith(".weight"):
        return 1.0, 0.1
    return 0.0, 0.05


@torch.no_grad()
def make_weights(shapes: dict, gen: torch.Generator, device, dtype=torch.float32,
                 fourier_scale: float = 0.02) -> dict:
    """{name: tensor} for ``shapes`` ({name: shape}): one normal draw for all
    of them on ``device``, cut in the order of the names and scaled per
    parameter, rounded to ``dtype`` (the type they are served in) and kept as
    float32."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, offset = {}, 0
    for name, size in zip(names, sizes):
        shape = shapes[name]
        base, std = init_scale(name, shape, fourier_scale)
        w = flat[offset:offset + size].view(shape) * std + base
        out[name] = w.to(dtype).float()
        offset += size
    return out


@torch.no_grad()
def synthetic_waveforms(gen: torch.Generator, n: int, t: int, device, fs: float = 100.0,
                        chunk: int = 512):
    """(waveforms (n, 3, t) float32, normalised cond (n, 5)): P and S bursts of
    band-limited noise whose onsets, corner frequencies, durations and
    amplitudes follow the conditioning (the port's synthetic data set, as
    arrays on the device), plus a 0.002 noise floor."""
    lo = torch.tensor([r[0] for r in FEATURE_RANGES], device=device)
    hi = torch.tensor([r[1] for r in FEATURE_RANGES], device=device)
    raw = lo + (hi - lo) * torch.rand((n, 5), generator=gen, device=device)
    dist, mag, vs30 = raw[:, 0], raw[:, 1], raw[:, 2]
    p_on = 5.0 + 2 * torch.rand(n, generator=gen, device=device) - 1.0
    s_on = p_on + dist * (1 / 3.5 - 1 / 6.0)
    amp = 10.0 ** (0.8 * (mag - 6.0) - 1.2 * torch.log10(dist / 100.0)
                   + 0.4 * torch.log10(760.0 / vs30))
    fc = 10.0 ** (1.1 - 0.3 * (mag - 4.5) - 0.2 * torch.log10(dist / 30.0))
    tau_p, tau_s = 0.5 + 0.4 * (mag - 4.5), 1.5 + 1.2 * (mag - 4.5) + 0.015 * dist
    tt = torch.arange(t, device=device) / fs
    freqs = torch.fft.rfftfreq(t, d=1 / fs, device=device)
    highpass = (freqs / 0.1) ** 2
    highpass = highpass / (1 + highpass)
    p_pol = torch.tensor([0.3, 0.3, 1.0], device=device)
    s_pol = torch.tensor([1.0, 1.0, 0.4], device=device)
    waves = torch.empty(n, 3, t, device=device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)

        def burst(onset, tau):
            u = (tt[None] - onset[s:e, None]).clamp(min=0) / tau[s:e, None]
            return (u * torch.exp(1 - u))[:, None]

        def noise(corner):
            spec = torch.fft.rfft(torch.randn((e - s, 3, t), generator=gen, device=device))
            lowpass = 1 / (1 + (freqs[None, None] / corner[:, None, None]) ** 2)
            return torch.fft.irfft(spec * lowpass * highpass, n=t)

        tr = (0.35 * p_pol[None, :, None] * burst(p_on, tau_p) * noise(2.5 * fc[s:e])
              + s_pol[None, :, None] * burst(s_on, tau_s) * noise(fc[s:e]))
        rms = tr.square().mean(dim=(1, 2), keepdim=True).sqrt() + 1e-12
        waves[s:e] = amp[s:e, None, None] * tr / rms
    waves += 0.002 * torch.randn((n, 3, t), generator=gen, device=device)
    mean = torch.tensor([st[0] for st in FEATURE_STATS], device=device)
    std = torch.tensor([st[1] for st in FEATURE_STATS], device=device)
    return waves, (raw - mean) / std


@torch.no_grad()
def load_weights(weights: dict, modules) -> None:
    """Copy the benchmark's weights into the program's modules by name; the
    program's parameters have to be exactly the configuration's."""
    names = {}
    for module in modules:
        if module is not None:
            names |= dict(module.named_parameters())
    mine = {n: tuple(p.shape) for n, p in names.items()}
    theirs = {n: tuple(w.shape) for n, w in weights.items()}
    if mine != theirs:
        diff = sorted(set(mine.items()) ^ set(theirs.items()))[:6]
        raise SystemExit(f"the port's parameters differ from the configuration's: {diff}")
    for n, p in names.items():
        p.copy_(weights[n])
