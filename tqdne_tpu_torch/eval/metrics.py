"""Evaluation metrics: the port of ``tqdne_tpu/eval/metrics.py``.

- ``frechet_distance``: full (matrix-sqrt) and isotropic variants;
- ``MeanSquaredError``, ``AmplitudeSpectralDensity`` (Frechet distance
  between log-|rfft| distributions, per channel) and ``asd_loss``;
- ``FrechetInceptionDistance`` / ``InceptionScore`` on the conditioning
  classifier's embeddings / logits.

The statistics stay on the host in float64 numpy (they are small); the
classifier runs on its own device under ``torch.no_grad()``, in batches.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch


def _psd_sqrt(mat: np.ndarray) -> np.ndarray:
    """Symmetric PSD square root via eigendecomposition (negative
    eigenvalues from sampling noise are clipped to zero)."""
    vals, vecs = np.linalg.eigh(mat)
    return (vecs * np.sqrt(np.clip(vals, 0.0, None))) @ vecs.T


def frechet_distance(x: np.ndarray, y: np.ndarray, isotropic: bool = False) -> float:
    """Squared 2-Wasserstein distance between Gaussians fitted to two
    sample sets.  The cross term trace(sqrt(Cx Cy)) is evaluated as
    sum(sqrt(eig(Cx^1/2 Cy Cx^1/2))), which stays real for PSD covariances."""
    x = np.asarray(x, np.float64).reshape(len(x), -1)
    y = np.asarray(y, np.float64).reshape(len(y), -1)
    dmu = x.mean(0) - y.mean(0)
    if isotropic:
        return float(dmu @ dmu + np.sum((x.std(0) - y.std(0)) ** 2))

    cov_x = np.cov(x, rowvar=False)
    cov_y = np.cov(y, rowvar=False)
    rx = _psd_sqrt(cov_x)
    cross_eigs = np.linalg.eigvalsh(rx @ cov_y @ rx)
    gm_trace = np.sqrt(np.clip(cross_eigs, 0.0, None)).sum()
    return float(dmu @ dmu + np.trace(cov_x) + np.trace(cov_y) - 2.0 * gm_trace)


class Metric(ABC):
    """Per-channel metric over (pred, target) waveform batches (B, C, T)."""

    def __init__(self, channel: int | None = 0):
        self.channel = channel

    @property
    def name(self) -> str:
        return f"{self.__class__.__name__} - Channel {self.channel}"

    def __call__(self, pred, target):
        pred = np.asarray(pred)
        target = np.asarray(target)
        if self.channel is not None:
            pred = pred[:, self.channel]
            target = target[:, self.channel]
        return self.compute(pred, target)

    @abstractmethod
    def compute(self, pred, target):
        ...


class MeanSquaredError(Metric):
    def compute(self, pred, target):
        return float(((pred - target) ** 2).mean())


class AmplitudeSpectralDensity(Metric):
    """Frechet distance between log amplitude-spectral-density sets."""

    def __init__(self, fs: float, channel: int = 0, log_eps: float = 1e-8, isotropic: bool = True):
        super().__init__(channel)
        self.fs = fs
        self.log_eps = log_eps
        self.isotropic = isotropic

    def spectral_density(self, signal: np.ndarray) -> np.ndarray:
        sd = np.abs(np.fft.rfft(signal, axis=-1))
        return np.log(np.clip(sd, self.log_eps, None))

    def compute(self, pred, target):
        return frechet_distance(
            self.spectral_density(pred), self.spectral_density(target), isotropic=self.isotropic
        )


def asd_loss(pred, target, log_eps: float = 1e-8) -> float:
    """MSE between log amplitude spectral densities."""
    def log_asd(x):
        return np.log(np.clip(np.abs(np.fft.rfft(np.asarray(x), axis=-1)), log_eps, None))

    return float(((log_asd(pred) - log_asd(target)) ** 2).mean())


def inception_score(logits: np.ndarray) -> float:
    """exp(E[KL(p(y|x) || p(y))]) over the softmax of (N, K) logits."""
    logits = logits - logits.max(-1, keepdims=True)
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    marginal = prob.mean(axis=0)
    kl = np.sum(prob * (np.log(prob + 1e-12) - np.log(marginal + 1e-12)), axis=-1)
    return float(np.exp(kl.mean()))


class _NeuralMetric:
    """Shared plumbing: run the classifier (a ``models.classifier.Classifier``
    on its device) on waveforms through the representation."""

    def __init__(self, classifier, representation, batch_size: int = 32):
        self.classifier = classifier
        self.representation = representation
        self.batch_size = batch_size

    @property
    def name(self) -> str:
        return self.__class__.__name__

    @torch.no_grad()
    def _batched(self, fn, waveforms) -> np.ndarray:
        """``fn`` over the channels-last signals of (N, C, T) waveforms, in
        batches on the classifier's device; f32 numpy out."""
        device = next(self.classifier.parameters()).device
        waveforms = torch.as_tensor(np.asarray(waveforms, np.float32))
        outs = []
        for i in range(0, len(waveforms), self.batch_size):
            signal = self.representation.get_representation(
                waveforms[i : i + self.batch_size].to(device))
            outs.append(fn(signal.movedim(1, -1)).cpu().numpy())
        return np.concatenate(outs)


class FrechetInceptionDistance(_NeuralMetric):
    """FID on classifier embeddings."""

    def __call__(self, pred, target):
        embed = self.classifier.embed
        return frechet_distance(self._batched(embed, pred), self._batched(embed, target))


class InceptionScore(_NeuralMetric):
    """IS on classifier logits."""

    def __call__(self, pred, target=None):
        return inception_score(self._batched(self.classifier, pred))
