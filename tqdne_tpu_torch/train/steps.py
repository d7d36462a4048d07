"""Train, eval and sample steps: the port of ``tqdne_tpu/train/steps.py``
(``make_edm_steps`` for the flagship latent EDM, ``make_autoencoder_steps``
and ``make_classifier_steps``).

Batches are dicts of channels-last tensors: ``signal`` (B, *S, C), or with
a ``device_representation`` the raw ``waveform`` (B, T, C) that the step
turns into the signal on the device; ``cond`` (B, F); with cached latents
``latent_mean``/``latent_log_std``; ``label`` (B,) for the classifier.
The frozen autoencoder encodes the signal inside the EDM step, without
gradients.  Every random draw of a step (the encoder's eps, the sigma
normal, the diffusion noise) is injectable, as the parity tests need; left
out, each comes from the step's ``generator`` in that order.  Dropout draws
from the device's default generator.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F

from tqdne_tpu_torch.diffusion import edm as edm_lib
from tqdne_tpu_torch.diffusion import sampler as sampler_lib
from tqdne_tpu_torch.models.autoencoder import kl_divergence
from tqdne_tpu_torch.models.classifier import weighted_cross_entropy
from tqdne_tpu_torch.train.state import TrainState, apply_updates


def _signal(batch: dict, device_representation=None):
    if device_representation is not None:
        return device_representation(batch["waveform"])
    return batch["signal"]


def _no_cond_signal(batch: dict):
    if batch.get("cond_signal") is not None:
        raise ValueError("cond_signal pairs are not ported yet")


def edm_step_loss(unet, batch: dict, edm_cfg: edm_lib.EDMConfig = edm_lib.EDMConfig(), *,
                  autoencoder=None, latent_moments: bool = False, device_representation=None,
                  draws: dict | None = None, generator: torch.Generator | None = None):
    """The JAX ``_loss`` of ``make_edm_steps``: encode (or sample the cached
    moments), then ``edm_loss`` through ``unet``.  ``draws`` may hold
    ``ae_eps``, ``sigma_eps`` and ``noise``."""
    draws = draws or {}
    _no_cond_signal(batch)
    if latent_moments:
        mean, log_std = batch["latent_mean"], batch["latent_log_std"]
        eps = draws.get("ae_eps")
        if eps is None:
            eps = torch.randn(mean.shape, generator=generator, device=mean.device,
                              dtype=mean.dtype)
        sample = mean + eps * torch.exp(log_std)
    else:
        sample = _signal(batch, device_representation)
        if autoencoder is not None:
            with torch.no_grad():
                sample = autoencoder.encode(sample, eps=draws.get("ae_eps"), generator=generator)
    return edm_lib.edm_loss(edm_cfg, unet, sample, cond=batch.get("cond"),
                            sigma_eps=draws.get("sigma_eps"), noise=draws.get("noise"),
                            generator=generator)


def make_edm_steps(edm_cfg: edm_lib.EDMConfig = edm_lib.EDMConfig(), *, autoencoder=None,
                   ema_decay: float = 0.999, latent_moments: bool = False,
                   device_representation=None):
    """Returns (train_step, eval_step) over a ``TrainState``.

    ``train_step(state, batch, *, draws=None, generator=None)`` runs the loss
    on the live module in train mode (dropout on), backpropagates, applies
    the optimizer and the EMA and returns ``{"loss": ...}``;
    ``eval_step(state, batch, ...)`` returns the loss of the EMA module,
    which the reference swaps in for every validation.
    """
    if latent_moments and autoencoder is None:
        raise ValueError("latent_moments requires an autoencoder (for decode)")
    if autoencoder is not None:
        autoencoder.eval().requires_grad_(False)
    kw = dict(autoencoder=autoencoder, latent_moments=latent_moments,
              device_representation=device_representation)

    def train_step(state: TrainState, batch: dict, *, draws=None, generator=None):
        state.model.train()
        loss = edm_step_loss(state.model, batch, edm_cfg, draws=draws, generator=generator, **kw)
        loss.backward()
        apply_updates(state, ema_decay)
        return {"loss": loss.detach()}

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict, *, draws=None, generator=None):
        return {"loss": edm_step_loss(state.ema, batch, edm_cfg, draws=draws,
                                      generator=generator, **kw)}

    return train_step, eval_step


def autoencoder_losses(ae, batch: dict, *, kl_weight: float = 1e-6, device_representation=None,
                       draws: dict | None = None, generator: torch.Generator | None = None) -> dict:
    """The JAX ``_losses`` of ``make_autoencoder_steps``: ``moments`` ->
    mean + eps exp(log_std) -> ``decode``; reconstruction MSE plus
    ``kl_weight`` x the mean KL.  ``draws`` may hold ``ae_eps``; left out, it
    comes from ``generator``."""
    _no_cond_signal(batch)
    x = _signal(batch, device_representation)
    mean, log_std = ae.moments(x)
    eps = (draws or {}).get("ae_eps")
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    recon = ae.decode(mean + eps.to(mean.dtype) * torch.exp(log_std))
    recon_loss = torch.mean((x - recon) ** 2)
    kl = torch.mean(kl_divergence(mean, log_std))
    return {"reconstruction_loss": recon_loss, "kl_divergence": kl,
            "loss": recon_loss + kl_weight * kl}


def make_autoencoder_steps(*, kl_weight: float = 1e-6, ema_decay: float = 0.999,
                           device_representation=None):
    """Returns (train_step, eval_step) of the KL autoencoder over a
    ``TrainState``: the train step runs ``autoencoder_losses`` on the live
    module in train mode (dropout on), backpropagates and applies the
    update; the eval step runs the EMA module in eval mode.  Both return
    ``reconstruction_loss``, ``kl_divergence`` and ``loss``."""
    kw = dict(kl_weight=kl_weight, device_representation=device_representation)

    def train_step(state: TrainState, batch: dict, *, draws=None, generator=None):
        state.model.train()
        metrics = autoencoder_losses(state.model, batch, draws=draws, generator=generator, **kw)
        metrics["loss"].backward()
        apply_updates(state, ema_decay)
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict, *, draws=None, generator=None):
        return autoencoder_losses(state.ema, batch, draws=draws, generator=generator, **kw)

    return train_step, eval_step


def classifier_outputs(clf, batch: dict, class_weights: torch.Tensor, *,
                       device_representation=None):
    """The JAX ``_loss`` of ``make_classifier_steps``: (logits, {"loss": the
    weighted cross-entropy, "accuracy"})."""
    logits = clf(_signal(batch, device_representation))
    label = batch["label"].long()
    loss = weighted_cross_entropy(logits, label, class_weights.to(logits.device))
    accuracy = (logits.argmax(-1) == label).float().mean()
    return logits, {"loss": loss, "accuracy": accuracy}


def confusion_metrics(means: dict) -> dict:
    """The JAX ``metric_postprocess`` of ``make_classifier_steps``: the
    epoch's mean per-class counts (``tp_counts``, ``pred_counts``,
    ``true_counts``) into macro accuracy (= macro recall), precision, recall
    and F1 over the classes that occur, as torchmetrics averages them."""
    means = dict(means)
    tp = np.asarray(means.pop("tp_counts"))
    pred = np.asarray(means.pop("pred_counts"))
    true = np.asarray(means.pop("true_counts"))
    with np.errstate(invalid="ignore", divide="ignore"):
        precision = np.where(pred > 0, tp / pred, 0.0)
        recall = np.where(true > 0, tp / true, 0.0)
        f1 = np.where(precision + recall > 0, 2 * precision * recall / (precision + recall), 0.0)
    seen = true > 0
    denom = max(int(seen.sum()), 1)
    return dict(means, macro_accuracy=float(recall[seen].sum() / denom),
                macro_precision=float(precision[seen].sum() / denom),
                macro_recall=float(recall[seen].sum() / denom),
                macro_f1=float(f1[seen].sum() / denom))


def make_classifier_steps(class_weights, *, ema_decay: float = 0.999,
                          device_representation=None):
    """Returns (train_step, eval_step, metric_postprocess) over a
    ``TrainState``: the train step (dropout on) reports ``loss`` and
    ``accuracy``; the eval step (the EMA module in eval mode) adds the
    per-class ``tp_counts``, ``pred_counts`` and ``true_counts``, which
    ``metric_postprocess`` (``confusion_metrics``) turns into the macro
    metrics once the epoch's are averaged."""
    class_weights = torch.as_tensor(np.asarray(class_weights, np.float32))
    num_classes = len(class_weights)
    kw = dict(device_representation=device_representation)

    def train_step(state: TrainState, batch: dict, *, draws=None, generator=None):
        state.model.train()
        _, metrics = classifier_outputs(state.model, batch, class_weights, **kw)
        metrics["loss"].backward()
        apply_updates(state, ema_decay)
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict, *, draws=None, generator=None):
        logits, metrics = classifier_outputs(state.ema, batch, class_weights, **kw)
        pred_1h = F.one_hot(logits.argmax(-1), num_classes).float()
        true_1h = F.one_hot(batch["label"].long(), num_classes).float()
        return metrics | {"tp_counts": (pred_1h * true_1h).sum(0),
                          "pred_counts": pred_1h.sum(0), "true_counts": true_1h.sum(0)}

    return train_step, eval_step, confusion_metrics


@torch.no_grad()
def sample_latent_edm(unet, autoencoder, shape: tuple[int, ...], cond=None, *,
                      edm_cfg: edm_lib.EDMConfig = edm_lib.EDMConfig(), num_steps: int = 25,
                      solver: str = "heun", cast_params=None,
                      noise=None, generator=None, device="cuda"):
    """Sample channels-last latents of ``shape`` and decode them to the
    signal (B, *spatial, C) in float32: the JAX ``sample_fn``.

    ``cast_params``: sample with a copy of the UNet whose parameters are cast
    to this dtype once, before the loop (the JAX ``cast_params``); the
    caller's module keeps its dtype.  The autoencoder computes in its own
    compute dtype.  ``noise``/``generator``: see ``diffusion.sampler.sample``.
    """
    if cast_params is not None:
        unet = copy.deepcopy(unet).to(cast_params)

    def denoise_fn(x, sigma):
        return edm_lib.precondition(edm_cfg, unet, x, sigma, cond=cond)

    latent = sampler_lib.sample(denoise_fn, shape, edm_cfg, num_steps=num_steps, solver=solver,
                                noise=noise, generator=generator, device=device)
    return autoencoder.decode(latent.float()).float()
