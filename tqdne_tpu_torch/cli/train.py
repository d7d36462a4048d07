"""Train the flagship chain on a GPU: the port of ``tqdne_tpu/cli/train.py``
for its three 2D log-spectrogram recipes, with the JAX run names, epochs,
batches and optimizers:

  autoencoder  Autoencoder-32x32x4-LogSpectrogram  300 epochs, batch 128, AdamW wd 1e-4
  latent_edm   Latent-EDM-32x32x8-LogSpectrogram   200 epochs, batch 256, Adam, EMA 0.999
  classifier   Classifier-LogSpectrogram           110 epochs, batch 64, Adam

Every optimizer runs at 1e-4 with the cosine schedule; the autoencoder and
the classifier keep no EMA (decay 0), as the reference trains them.  A user
trains in this order, in one workdir:

    python -m tqdne_tpu_torch.cli.train autoencoder --workdir W [--synthetic N] [--tiny]
    python -m tqdne_tpu_torch.cli.precompute_latents --workdir W [--tiny]
    python -m tqdne_tpu_torch.cli.train latent_edm --workdir W --cached-latents [--tiny]
    python -m tqdne_tpu_torch.cli.train classifier --workdir W [--tiny]

``latent_edm`` reads its frozen autoencoder from the ``autoencoder`` run in
the workdir, or from ``--ae-weights ae.pt`` (a state dict, e.g. converted by
``python -m tqdne_tpu_torch.utils.convert`` from the trained flax artifact).
``--device-representation`` (every recipe) computes the spectrogram on the
device; ``--skip-nonfinite N`` arms the non-finite guard; ``--cached-latents``
(``latent_edm``) trains from the precomputed moments.

Metrics go to ``W/outputs/<run>/metrics.jsonl`` and checkpoints under
``W/outputs/<run>/checkpoints``.  The dataset is HDF5 and needs ``h5py``.
Not ported yet, and refused: the other seven recipes, ``cond_signal`` pairs
and the sampling-eval callback.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

import torch

from tqdne_tpu_torch import configs
from tqdne_tpu_torch.cli import common
from tqdne_tpu_torch.cli.precompute_latents import ae_fingerprint, latents_path, sidecar_fingerprint
from tqdne_tpu_torch.data.dataset import ClassificationDataset
from tqdne_tpu_torch.data.pipeline import BatchLoader
from tqdne_tpu_torch.data.representation import Identity
from tqdne_tpu_torch.models.classifier import Classifier
from tqdne_tpu_torch.nn.layers import set_compute_dtype
from tqdne_tpu_torch.ops.representation import device_representation_fn
from tqdne_tpu_torch.train.loop import Trainer
from tqdne_tpu_torch.train.state import TrainState, cosine_annealing, make_optimizer
from tqdne_tpu_torch.train.steps import (
    make_autoencoder_steps,
    make_classifier_steps,
    make_edm_steps,
)
from tqdne_tpu_torch.utils import init_like_flax_, resolve_device

RUN_NAME = common.RUN_NAME
LEARNING_RATE = 1e-4  # every recipe's peak, under the cosine schedule


@dataclasses.dataclass
class Recipe:
    name: str
    config_cls: type
    epochs: int
    batch: int
    kind: str
    latent: bool = False
    optimizer: str = "adam"
    weight_decay: float = 0.0
    ema_decay: float = 0.0


RECIPES = {
    "autoencoder": Recipe(common.AE_NAME, configs.LatentSpectrogramConfig, 300, 128,
                          "autoencoder", optimizer="adamw", weight_decay=1e-4),
    "latent_edm": Recipe(RUN_NAME, configs.LatentSpectrogramConfig, 200, 256, "edm", latent=True,
                         ema_decay=0.999),
    "classifier": Recipe("Classifier-LogSpectrogram", configs.SpectrogramClassificationConfig,
                         110, 64, "classifier"),
}
# the JAX package's recipes (tqdne_tpu/cli/train.py:RECIPES); the others are refused
JAX_RECIPES = ("1d_edm", "1d_autoencoder", "1d_latent_edm", "autoencoder", "edm", "latent_edm",
               "classifier", "consistency", "latent_consistency", "latent_distill", "ddpm")


def _device_representation(config):
    representation = config.make_representation()
    rep = device_representation_fn(representation)
    if rep is None:
        raise SystemExit(f"no device transform for {type(representation).__name__}")
    return rep


def _fit(recipe, args, config, device, model, train_loader, val_loader, steps, hparams,
         epochs, metric_postprocess=None) -> TrainState:
    """The optimizer, schedule, guard and ``Trainer`` around ``model``."""
    max_steps = args.max_steps or epochs * len(train_loader)
    lr_schedule = cosine_annealing(LEARNING_RATE, max_steps)
    optimizer = make_optimizer(recipe.optimizer, model, LEARNING_RATE, recipe.weight_decay)
    state = TrainState(model, optimizer, lr_schedule, skip_nonfinite=args.skip_nonfinite)
    trainer = Trainer(*steps, config.outputdir / recipe.name, device=device, max_epochs=epochs,
                      max_steps=args.max_steps, seed=args.seed, lr_schedule=lr_schedule,
                      hparams=hparams, checkpoint_every_epochs=args.checkpoint_every,
                      eval_every_epochs=args.val_every, metric_postprocess=metric_postprocess)
    return trainer.fit(state, train_loader, val_loader, resume=not args.no_resume)


def _placed(module, device):
    memory_format = torch.channels_last if device.type == "cuda" else torch.preserve_format
    return module.to(device, memory_format=memory_format)


def run(args) -> TrainState:
    if args.recipe not in RECIPES:
        raise SystemExit(f"recipe {args.recipe!r} is not ported yet (have: {', '.join(RECIPES)})")
    recipe = RECIPES[args.recipe]
    if args.cached_latents and not recipe.latent:
        raise SystemExit("--cached-latents needs a latent EDM, consistency or distill recipe")
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    dtype = common.parse_dtype(args.dtype)
    config = recipe.config_cls(workdir=args.workdir)
    common.ensure_dataset(config, args.synthetic)
    batch = args.batchsize or recipe.batch
    epochs = args.max_epochs or recipe.epochs
    device_rep = _device_representation(config) if args.device_representation else None
    if recipe.kind == "classifier":
        return _run_classifier(recipe, args, config, device, dtype, batch, epochs, device_rep)
    if recipe.kind == "autoencoder":
        keys = ("waveform",) if device_rep is not None else ("signal",)
        train_loader, val_loader, _ = common.make_loaders(
            config, batch, cond=False, device=device, keys=keys,
            host_representation=device_rep is None)
        ae, enc_cfg, dec_cfg = common.build_autoencoder(config, dtype, tiny=args.tiny)
        init_like_flax_(ae, args.seed)
        steps = make_autoencoder_steps(kl_weight=config.kl_weight, ema_decay=recipe.ema_decay,
                                       device_representation=device_rep)
        return _fit(recipe, args, config, device, _placed(ae, device), train_loader, val_loader,
                    steps, common.autoencoder_hparams(config, enc_cfg, dec_cfg), epochs)
    return _run_latent_edm(recipe, args, config, device, dtype, batch, epochs, device_rep)


def _run_latent_edm(recipe, args, config, device, dtype, batch, epochs, device_rep):
    ae, enc_cfg, _ = common.frozen_autoencoder(config, dtype, tiny=args.tiny,
                                               weights=args.ae_weights)
    lat_path = None
    if args.cached_latents:
        lat_path = latents_path(config, common.AE_NAME)
        if not lat_path.exists():
            raise SystemExit(f"{lat_path} not found — run `python -m "
                             f"tqdne_tpu_torch.cli.precompute_latents --workdir {args.workdir}` "
                             "first")
        # the sidecar must come from these weights: a retrained autoencoder of the same
        # architecture would shift the latent space silently
        stored, fp = sidecar_fingerprint(lat_path), ae_fingerprint(ae.state_dict())
        if stored != fp:
            raise SystemExit(f"{lat_path} was computed from different AE weights (fingerprint "
                             f"{stored} != {fp}) — re-run tqdne-precompute-latents")
        keys = ("latent_mean", "latent_log_std", "cond")
    elif device_rep is not None:
        keys = ("waveform", "cond")
    else:
        keys = ("signal", "cond")
    train_loader, val_loader, _ = common.make_loaders(
        config, batch, cond=True, device=device, keys=keys,
        host_representation=device_rep is None and lat_path is None, latents_path=lat_path)
    model_shape = common.latent_shape(enc_cfg, common.signal_shape(config))
    overrides = {"model_channels": common.TINY_CHANNELS} if args.tiny else {}
    unet, ucfg = common.build_unet(config, model_shape[-1], model_shape[-1], dtype, **overrides)
    init_like_flax_(unet, args.seed)
    _placed(ae, device)
    steps = make_edm_steps(autoencoder=ae, ema_decay=recipe.ema_decay,
                           latent_moments=lat_path is not None, device_representation=device_rep)
    hparams = {"kind": "edm", "dims": 2, "latent": True, "ae_name": common.AE_NAME,
               "unet": ucfg, "dtype": args.dtype}
    return _fit(recipe, args, config, device, _placed(unet, device), train_loader, val_loader,
                steps, hparams, epochs)


def _run_classifier(recipe, args, config, device, dtype, batch, epochs, device_rep):
    """Class weights from the ``train_validation`` split, validation on ``test``."""
    ds_rep = Identity() if device_rep is not None else config.make_representation()
    keys = ("waveform", "label") if device_rep is not None else ("signal", "label")

    def dataset(split):
        return ClassificationDataset(config.datapath, ds_rep, config.mag_bins, config.dist_bins,
                                     cut=config.t, split=split)

    ds_train, ds_val = dataset("train_validation"), dataset("test")
    train_loader = BatchLoader(ds_train, batch, device=device, keys=keys)
    val_loader = BatchLoader(ds_val, max(1, min(batch, len(ds_val))), shuffle=False,
                             drop_last=True, device=device, keys=keys)
    enc_cfg = configs.get_classifier_encoder_config(config)
    if args.tiny:
        enc_cfg |= {"model_channels": 16, "out_channels": 32}
    clf = set_compute_dtype(Classifier(enc_cfg, config.num_classes), dtype)
    init_like_flax_(clf, args.seed)
    train_step, eval_step, metric_post = make_classifier_steps(
        ds_train.get_class_weights(), ema_decay=recipe.ema_decay,
        device_representation=device_rep)
    hparams = {"kind": "classifier", "encoder": enc_cfg, "num_classes": config.num_classes}
    return _fit(recipe, args, config, device, _placed(clf, device), train_loader, val_loader,
                (train_step, eval_step), hparams, epochs, metric_post)


def main(argv=None):
    parser = argparse.ArgumentParser("tqdne_tpu_torch.cli.train",
                                     description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="recipe", required=True)
    for key in JAX_RECIPES:
        common.add_common_args(sub.add_parser(key))
    return run(parser.parse_args(argv))


if __name__ == "__main__":
    main()
