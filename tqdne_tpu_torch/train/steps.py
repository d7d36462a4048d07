"""Train, eval and sample steps: the port of ``tqdne_tpu/train/steps.py``
(``make_edm_steps`` with or without a frozen autoencoder,
``make_autoencoder_steps`` and ``make_classifier_steps``) and the EDM
``sample_fn`` (``sample_edm``), in 1D and 2D.

Batches are dicts of channels-last tensors: ``signal`` (B, *S, C), or with
a ``device_representation`` the raw ``waveform`` (B, T, C) that the step
turns into the signal on the device; ``cond`` (B, F); a paired batch's
``cond_signal`` (B, *S, C), which the network sees concatenated after its
input on the channel axis; with cached latents ``latent_mean``/
``latent_log_std``; ``label`` (B,) for the classifier.  The frozen
autoencoder encodes the signal (and a ``cond_signal``, with a draw of its
own) inside the EDM step, without gradients.  Every random draw of a step
(the encoder's eps, the ``cond_signal`` encoder's eps, the sigma normal,
the diffusion noise) is injectable, as the parity tests need; left out,
each comes from the step's ``generator`` in that order, at the global
batch's shape with this rank's rows kept (``parallel.draw_rows``).  Dropout
draws from the device's default generator, which is each rank's own.

Under a process group each rank's batch is its rows of the global batch.
The mean losses then average over the ranks into the global mean; the
classifier's weighted cross-entropy is normalised by the global sum of its
class weights, and its confusion counts are summed over the ranks.  With a
spatial ``mesh`` (``parallel.spatial``, the EDM steps and ``sample_edm``) each
rank's batch is its block (``spatial.shard_batch``): its data rank's rows and
its model rank's rows of each signal, the loss the mean over the sample's
shards, and the gradients summed over the model group and averaged over the
data group.
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch
import torch.nn.functional as F

from tqdne_tpu_torch.diffusion import edm as edm_lib
from tqdne_tpu_torch.diffusion import sampler as sampler_lib
from tqdne_tpu_torch.models.autoencoder import kl_divergence
from tqdne_tpu_torch.models.classifier import weighted_cross_entropy
from tqdne_tpu_torch.parallel import all_reduce_sum, draw_rows, spatial, world_size
from tqdne_tpu_torch.train.state import TrainState, apply_updates
from tqdne_tpu_torch.utils.tracing import span


def _signal(batch: dict, device_representation=None):
    if device_representation is not None:
        return device_representation(batch["waveform"])
    return batch["signal"]


def training_sample(batch: dict, *, autoencoder=None, latent_moments: bool = False,
                    device_representation=None, ae_eps=None,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """What a diffusion step trains on (the JAX ``_sample_of``): the cached
    moments' sample mean + eps exp(log_std), or the signal (computed on the
    device with a ``device_representation``), encoded by the frozen
    ``autoencoder`` without gradients when there is one.  ``ae_eps`` is
    drawn from ``generator`` when None."""
    if latent_moments:
        mean, log_std = batch["latent_mean"], batch["latent_log_std"]
        if ae_eps is None:
            ae_eps = draw_rows(torch.randn, mean.shape, generator=generator, device=mean.device,
                               dtype=mean.dtype)
        return mean + ae_eps * torch.exp(log_std)
    sample = _signal(batch, device_representation)
    if autoencoder is not None:
        with torch.no_grad():
            sample = autoencoder.encode(sample, eps=ae_eps, generator=generator)
    return sample


def edm_step_loss(unet, batch: dict, edm_cfg: edm_lib.EDMConfig = edm_lib.EDMConfig(), *,
                  autoencoder=None, latent_moments: bool = False, device_representation=None,
                  draws: dict | None = None, generator: torch.Generator | None = None):
    """The JAX ``_loss`` of ``make_edm_steps``: encode (or sample the cached
    moments), encode a ``cond_signal`` with its own draw when there is an
    autoencoder, then ``edm_loss`` through ``unet``.  ``draws`` may hold
    ``ae_eps``, ``cond_ae_eps``, ``sigma_eps`` and ``noise``."""
    draws = draws or {}
    cond_signal = batch.get("cond_signal")
    if latent_moments and cond_signal is not None:
        raise ValueError("cached latents do not support cond_signal pairs")
    sample = training_sample(batch, autoencoder=autoencoder, latent_moments=latent_moments,
                             device_representation=device_representation,
                             ae_eps=draws.get("ae_eps"), generator=generator)
    if cond_signal is not None and autoencoder is not None:
        with torch.no_grad():
            cond_signal = autoencoder.encode(cond_signal, eps=draws.get("cond_ae_eps"),
                                             generator=generator)
    return edm_lib.edm_loss(edm_cfg, unet, sample, cond_signal=cond_signal,
                            cond=batch.get("cond"), sigma_eps=draws.get("sigma_eps"),
                            noise=draws.get("noise"), generator=generator)


def make_edm_steps(edm_cfg: edm_lib.EDMConfig = edm_lib.EDMConfig(), *, autoencoder=None,
                   ema_decay: float = 0.999, latent_moments: bool = False,
                   device_representation=None, mesh=None):
    """Returns (train_step, eval_step) over a ``TrainState``.

    ``train_step(state, batch, *, draws=None, generator=None)`` runs the loss
    on the live module in train mode (dropout on), backpropagates, applies
    the optimizer and the EMA and returns ``{"loss": ...}``;
    ``eval_step(state, batch, ...)`` returns the loss of the EMA module,
    which the reference swaps in for every validation.  With a spatial
    ``mesh`` both run under ``spatial_scope(mesh)`` on the rank's block of the
    batch (and of injected draws).
    """
    if latent_moments and autoencoder is None:
        raise ValueError("latent_moments requires an autoencoder (for decode)")
    if autoencoder is not None:
        autoencoder.eval().requires_grad_(False)
    kw = dict(autoencoder=autoencoder, latent_moments=latent_moments,
              device_representation=device_representation)

    def scope():
        return spatial.spatial_scope(mesh) if mesh is not None else contextlib.nullcontext()

    def train_step(state: TrainState, batch: dict, *, draws=None, generator=None):
        state.model.train()
        with scope():
            with span("loss"):
                loss = edm_step_loss(state.model, batch, edm_cfg, draws=draws,
                                     generator=generator, **kw)
            with span("backward"):
                loss.backward()
            apply_updates(state, ema_decay)
        return {"loss": loss.detach()}

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict, *, draws=None, generator=None):
        with scope():
            return {"loss": edm_step_loss(state.ema, batch, edm_cfg, draws=draws,
                                          generator=generator, **kw)}

    return train_step, eval_step


def autoencoder_losses(ae, batch: dict, *, kl_weight: float = 1e-6, device_representation=None,
                       draws: dict | None = None, generator: torch.Generator | None = None) -> dict:
    """The JAX ``_losses`` of ``make_autoencoder_steps``: ``moments`` ->
    mean + eps exp(log_std) -> ``decode``; reconstruction MSE plus
    ``kl_weight`` x the mean KL.  A paired batch's ``cond_signal`` is
    reconstructed the same way with its own eps, reported as
    ``cond_reconstruction_loss`` and ``cond_kl_divergence``, and its
    reconstruction plus ``kl_weight`` x its KL added to ``loss``, the
    objective.  ``draws`` may hold ``ae_eps`` and ``cond_ae_eps``; left out,
    each comes from ``generator`` in that order."""
    draws = draws or {}

    def run(x, eps):
        mean, log_std = ae.moments(x)
        if eps is None:
            eps = draw_rows(torch.randn, mean.shape, generator=generator, device=mean.device,
                            dtype=mean.dtype)
        recon = ae.decode(mean + eps.to(mean.dtype) * torch.exp(log_std))
        return torch.mean((x - recon) ** 2), torch.mean(kl_divergence(mean, log_std))

    recon_loss, kl = run(_signal(batch, device_representation), draws.get("ae_eps"))
    metrics = {"reconstruction_loss": recon_loss, "kl_divergence": kl,
               "loss": recon_loss + kl_weight * kl}
    if batch.get("cond_signal") is not None:
        c_recon, c_kl = run(batch["cond_signal"], draws.get("cond_ae_eps"))
        metrics |= {"cond_reconstruction_loss": c_recon, "cond_kl_divergence": c_kl,
                    "loss": metrics["loss"] + c_recon + kl_weight * c_kl}
    return metrics


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
        with span("loss"):
            metrics = autoencoder_losses(state.model, batch, draws=draws, generator=generator,
                                         **kw)
        with span("backward"):
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
    weighted cross-entropy, "accuracy"}).  Under a process group the loss is
    normalised by the global batch's weight sum over the world size (the sum
    all-reduced without gradient), so the ranks' mean, of the losses and of
    their gradients, is the global loss."""
    logits = clf(_signal(batch, device_representation))
    label = batch["label"].long()
    class_weights = class_weights.to(logits.device)
    weight_sum = all_reduce_sum(class_weights[label].sum()) / world_size()
    loss = weighted_cross_entropy(logits, label, class_weights, weight_sum)
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
        with span("loss"):
            _, metrics = classifier_outputs(state.model, batch, class_weights, **kw)
        with span("backward"):
            metrics["loss"].backward()
        apply_updates(state, ema_decay)
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict, *, draws=None, generator=None):
        logits, metrics = classifier_outputs(state.ema, batch, class_weights, **kw)
        pred_1h = F.one_hot(logits.argmax(-1), num_classes).float()
        true_1h = F.one_hot(batch["label"].long(), num_classes).float()
        # the global batch's counts: summed over the ranks in one collective
        counts = all_reduce_sum(torch.stack([(pred_1h * true_1h).sum(0), pred_1h.sum(0),
                                             true_1h.sum(0)]))
        return metrics | dict(zip(("tp_counts", "pred_counts", "true_counts"), counts))

    return train_step, eval_step, confusion_metrics


@torch.no_grad()
def sample_edm(unet, shape: tuple[int, ...], cond=None, *, autoencoder=None,
               edm_cfg: edm_lib.EDMConfig = edm_lib.EDMConfig(), num_steps: int = 25,
               solver: str = "heun", cast_params=None, cond_signal=None, cond_eps=None,
               noise=None, generator=None, device="cuda", mesh=None):
    """Sample channels-last arrays of ``shape`` with the EDM ODE solver: the
    JAX ``sample_fn``.  With an ``autoencoder``, ``shape`` is the latent's and
    the sample is decoded to the signal (B, *spatial, C); without one the
    sample is the signal.  float32 either way.

    ``cond_signal``: a paired batch's conditioning signal, concatenated after
    the network's input at every eval; with an ``autoencoder`` it is first
    encoded stochastically, mean + ``cond_eps`` std (``cond_eps`` drawn from
    ``generator`` before the sampler's noise when None).
    ``cast_params``: sample with a copy of the UNet whose parameters are cast
    to this dtype once, before the loop (the JAX ``cast_params``); the
    caller's module keeps its dtype.  The autoencoder computes in its own
    compute dtype.  ``noise``/``generator``: see ``diffusion.sampler.sample``.
    ``mesh``: a spatial mesh (the JAX ``eps_sharding``): ``shape``, ``cond``,
    ``cond_signal``, ``cond_eps`` and ``noise`` are global, each rank samples and
    decodes its block under ``spatial_scope(mesh)``, and every rank returns the
    whole gathered signal.
    """
    if cast_params is not None:
        unet = copy.deepcopy(unet).to(cast_params)
    with spatial.spatial_scope(mesh) as scope:
        if scope is not None:
            cond, cond_signal, cond_eps, noise = (
                None if t is None else spatial.shard(mesh, t)
                for t in (cond, cond_signal, cond_eps, noise))
            shape = spatial.local_shape(scope, shape)
        if cond_signal is not None and autoencoder is not None:
            cond_signal = autoencoder.encode(cond_signal, eps=cond_eps, generator=generator)

        def denoise_fn(x, sigma):
            return edm_lib.precondition(edm_cfg, unet, x, sigma, cond_signal=cond_signal,
                                        cond=cond)

        out = sampler_lib.sample(denoise_fn, shape, edm_cfg, num_steps=num_steps,
                                 solver=solver, noise=noise, generator=generator, device=device)
        if autoencoder is not None:
            out = autoencoder.decode(out.float())
    out = out.float()
    return out if mesh is None else spatial.gather_signal(mesh, out)
