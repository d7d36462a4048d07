"""Train the flagship latent EDM on a GPU: the port of ``tqdne_tpu/cli/train.py``
for the ``latent_edm`` recipe (run name ``Latent-EDM-32x32x8-LogSpectrogram``,
200 epochs, batch 256, Adam at 1e-4 with a cosine schedule, EMA 0.999).

The frozen autoencoder is a ``.pt`` state dict written by
``python -m tqdne_tpu_torch.utils.convert`` from the trained flax artifact:

    python -m tqdne_tpu_torch.cli.train latent_edm --workdir W --ae-weights ae.pt \\
        [--synthetic N] [--tiny] [-b 256] [--max-steps S] [--dtype bf16] [--device cuda]

Metrics go to ``W/outputs/<run>/metrics.jsonl`` and checkpoints under
``W/outputs/<run>/checkpoints``.  The dataset is HDF5 and needs ``h5py``.
Not ported yet, and refused: the other recipes, ``--cached-latents``,
``--device-representation``, ``--skip-nonfinite`` and the sampling-eval
callback.
"""

from __future__ import annotations

import argparse
import logging

import torch

from tqdne_tpu_torch import configs
from tqdne_tpu_torch.cli import common
from tqdne_tpu_torch.train.loop import Trainer
from tqdne_tpu_torch.train.state import TrainState, cosine_annealing, make_optimizer
from tqdne_tpu_torch.train.steps import make_edm_steps
from tqdne_tpu_torch.utils import init_like_flax_, resolve_device

RUN_NAME = common.RUN_NAME
EPOCHS, BATCH, LR = 200, 256, 1e-4
# the JAX package's recipes (tqdne_tpu/cli/train.py:RECIPES); only latent_edm is ported
JAX_RECIPES = ("1d_edm", "1d_autoencoder", "1d_latent_edm", "autoencoder", "edm", "latent_edm",
               "classifier", "consistency", "latent_consistency", "latent_distill", "ddpm")


def run(args) -> TrainState:
    if args.recipe != "latent_edm":
        raise SystemExit(f"recipe {args.recipe!r} is not ported yet (have: latent_edm)")
    for flag in ("cached_latents", "device_representation", "skip_nonfinite"):
        if getattr(args, flag):
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported yet")
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    dtype = common.parse_dtype(args.dtype)
    config = configs.LatentSpectrogramConfig(workdir=args.workdir)
    common.ensure_dataset(config, args.synthetic)
    batch = args.batchsize or BATCH
    epochs = args.max_epochs or EPOCHS

    train_loader, val_loader, _ = common.make_loaders(config, batch, cond=True, device=device)
    max_steps = args.max_steps or epochs * len(train_loader)
    lr_schedule = cosine_annealing(LR, max_steps)

    ae, enc_cfg, dec_cfg = common.build_autoencoder(config, dtype, tiny=args.tiny)
    common.load_weights(ae, args.ae_weights, 0)
    model_shape = common.latent_shape(enc_cfg, common.signal_shape(config))
    overrides = {"model_channels": common.TINY_CHANNELS} if args.tiny else {}
    unet, ucfg = common.build_unet(config, model_shape[-1], model_shape[-1], dtype, **overrides)
    init_like_flax_(unet, args.seed)
    memory_format = torch.channels_last if device.type == "cuda" else torch.preserve_format
    for module in (unet, ae):
        module.to(device, memory_format=memory_format)

    state = TrainState(unet, make_optimizer("adam", unet, LR), lr_schedule)
    train_step, eval_step = make_edm_steps(autoencoder=ae)
    hparams = {"kind": "edm", "dims": 2, "latent": True, "ae_name": "Autoencoder-32x32x4-"
               "LogSpectrogram", "unet": ucfg, "dtype": args.dtype}
    trainer = Trainer(train_step, eval_step, config.outputdir / RUN_NAME, device=device,
                      max_epochs=epochs, max_steps=args.max_steps, seed=args.seed,
                      lr_schedule=lr_schedule, hparams=hparams,
                      checkpoint_every_epochs=args.checkpoint_every,
                      eval_every_epochs=args.val_every)
    return trainer.fit(state, train_loader, val_loader, resume=not args.no_resume)


def main(argv=None):
    parser = argparse.ArgumentParser("tqdne_tpu_torch.cli.train",
                                     description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="recipe", required=True)
    for key in JAX_RECIPES:
        common.add_common_args(sub.add_parser(key))
    run(parser.parse_args(argv))


if __name__ == "__main__":
    main()
