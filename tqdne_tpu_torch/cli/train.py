"""Train on a GPU: the port of ``tqdne_tpu/cli/train.py`` for all eleven of
its recipes, with the JAX run names, epochs, batches and optimizers, and the
port's own ``latent_dit``:

  1d_edm              EDM-MovingAvg                              200 epochs, batch 256, Adam
  1d_autoencoder      Autoencoder-1024x16-MovingAvg              200 epochs, batch 256, AdamW
  1d_latent_edm       Latent-EDM-MovingAvg-1024x16               300 epochs, batch 256, Adam
  autoencoder         Autoencoder-32x32x4-LogSpectrogram         300 epochs, batch 128, AdamW
  edm                 EDM-128x128-LogSpectrogram                 300 epochs, batch 64, Adam
  latent_edm          Latent-EDM-32x32x8-LogSpectrogram          200 epochs, batch 256, Adam
  latent_dit          Latent-DiT-XL2-32x32x8-LogSpectrogram      200 epochs, batch 256, Adam
  classifier          Classifier-LogSpectrogram                  110 epochs, batch 64, Adam
  consistency         Consistency-MovingAvg                      200 epochs, batch 256, RAdam
  latent_consistency  Latent-Consistency-32x32x8-LogSpectrogram  200 epochs, batch 256, RAdam
  latent_distill      Latent-Distill-32x32x8-LogSpectrogram       80 epochs, batch 256, RAdam
  ddpm                DDPM-MovingAvg                             200 epochs, batch 256, AdamW

Adam and AdamW run at 1e-4 under the cosine schedule, RAdam at a constant
1e-4; the autoencoders' AdamW decays at 1e-4, DDPM's at 0.  The autoencoders
and the classifier keep no EMA (decay 0), the diffusion recipes an EMA of
0.999, and ``latent_distill`` its CD target network at ``--ema-decay`` (0.95).
A latent recipe trains after its autoencoder, in one workdir:

    python -m tqdne_tpu_torch.cli.train autoencoder --workdir W [--synthetic N] [--tiny]
    python -m tqdne_tpu_torch.cli.precompute_latents --workdir W [--tiny]
    python -m tqdne_tpu_torch.cli.train latent_edm --workdir W --cached-latents [--tiny]
    python -m tqdne_tpu_torch.cli.train latent_distill --workdir W [--teacher RUN] [--tiny]
    python -m tqdne_tpu_torch.cli.train classifier --workdir W [--tiny]

and the same with ``1d_autoencoder``, ``precompute_latents --config
1d_latent_edm`` and ``1d_latent_edm``; ``latent_consistency`` and ``latent_dit`` (DiT-XL/2 in
the UNet's place; its widths stored under ``dit`` in ``hparams.json``) train
like ``latent_edm``; ``1d_edm``, ``edm``, ``consistency`` and ``ddpm`` need no
autoencoder.  ``latent_distill`` distills the EDM run ``--teacher`` (default:
its run name with ``Distill`` -> ``EDM``, the flagship): the student is
rebuilt at the teacher's stored widths and starts from its EMA weights.  A
latent recipe reads its frozen autoencoder from the autoencoder's run in the
workdir, or from ``--ae-weights ae.pt`` (a state dict, e.g. converted by
``python -m tqdne_tpu_torch.utils.convert`` from a trained flax artifact).
``--device-representation`` computes the spectrogram or the envelope on the
device (every recipe but ``ddpm``); ``--skip-nonfinite N`` arms the
non-finite guard; ``--cached-latents`` (the latent EDM, consistency and
distill recipes) trains from the precomputed moments.

On N cards every recipe trains data-parallel, one rank a card, ``-b`` being
the global batch: ``torchrun --nproc-per-node N -m tqdne_tpu_torch.cli.train
<recipe> ...`` (``-d``, when given, must equal torchrun's world size), or
``-d N`` without torchrun, which starts the N ranks itself.  ``-d`` above the
visible cards exits.  ``--num-slices K`` lays the ranks out as a (replica,
data) mesh of K slices.  Dropout masks are each rank's own; at ``--dropout
0`` an N-rank run computes what one rank computes at the same global batch.

Metrics go to ``W/outputs/<run>/metrics.jsonl`` and checkpoints under
``W/outputs/<run>/checkpoints``.  The dataset is HDF5 and needs ``h5py``.
Every ``--eval-every`` epochs (10) the diffusion recipes' sampling-eval
callback samples the first two validation batches with the EMA model at the
JAX step factories' defaults (the EDM kinds Heun at 25 steps, decoded for a
latent recipe; the consistency kinds one eval and one refinement at sigma 1;
DDPM its timesteps), writes the isotropic ASD of each channel as
``eval/<metric>`` and, where matplotlib is installed, the figures under
``W/outputs/<run>/plots/epoch_<e>/``.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import logging
import os

import torch

from tqdne_tpu_torch import configs
from tqdne_tpu_torch.cli import common
from tqdne_tpu_torch.cli.common import RECIPES
from tqdne_tpu_torch.cli.precompute_latents import ae_fingerprint, latents_path, sidecar_fingerprint
from tqdne_tpu_torch.data.dataset import ClassificationDataset
from tqdne_tpu_torch.data.pipeline import BatchLoader
from tqdne_tpu_torch.data.representation import Identity
from tqdne_tpu_torch.diffusion import ddpm as ddpm_lib
from tqdne_tpu_torch.diffusion.consistency import (ConsistencyConfig, make_consistency_steps,
                                                   sample_consistency)
from tqdne_tpu_torch.diffusion.distillation import make_distillation_steps, sample_distilled
from tqdne_tpu_torch.eval.metrics import AmplitudeSpectralDensity
from tqdne_tpu_torch.models.unet import UNet
from tqdne_tpu_torch.models.classifier import Classifier
from tqdne_tpu_torch.nn.layers import set_compute_dtype
from tqdne_tpu_torch.ops.representation import device_representation_fn
from tqdne_tpu_torch.parallel import (local_device, make_hybrid_mesh, make_mesh, process_group,
                                      replicate_, world_size)
from tqdne_tpu_torch.train.callbacks import SamplingEvalCallback
from tqdne_tpu_torch.train.loop import Trainer
from tqdne_tpu_torch.train.state import TrainState, cosine_annealing, make_optimizer
from tqdne_tpu_torch.train.steps import (
    make_autoencoder_steps,
    make_classifier_steps,
    make_edm_steps,
    sample_edm,
)
from tqdne_tpu_torch.utils import init_like_flax_, resolve_device

RUN_NAME = common.RUN_NAME
LEARNING_RATE = 1e-4  # every recipe's: the cosine schedule's peak, or RAdam's constant rate
EVAL_BATCHES = 2  # validation batches the sampling-eval callback samples
WAVE_CHANNELS = 3
logger = logging.getLogger("tqdne_tpu_torch")


def _dropout(args) -> dict:
    """The model config's ``dropout`` override of ``--dropout``, if given."""
    return {} if args.dropout is None else {"dropout": args.dropout}


def _device_representation(config):
    representation = config.make_representation()
    rep = device_representation_fn(representation)
    if rep is None:
        raise SystemExit(f"no device transform for {type(representation).__name__}")
    return rep


def _max_steps(args, epochs: int, train_loader) -> int:
    return args.max_steps or epochs * len(train_loader)


def _fit(recipe, args, config, device, model, train_loader, val_loader, steps, hparams,
         epochs, metric_postprocess=None, callbacks=()) -> TrainState:
    """The optimizer, schedule, guard and ``Trainer`` around ``model``: the
    cosine schedule, except for RAdam, which runs at a constant rate as the
    JAX CLI runs it."""
    lr_schedule = None
    if recipe.optimizer != "radam":
        lr_schedule = cosine_annealing(LEARNING_RATE, _max_steps(args, epochs, train_loader))
    replicate_(model)  # every rank starts from rank 0's weights
    optimizer = make_optimizer(recipe.optimizer, model, LEARNING_RATE, recipe.weight_decay)
    state = TrainState(model, optimizer, lr_schedule, skip_nonfinite=args.skip_nonfinite)
    trainer = Trainer(*steps, config.outputdir / recipe.name, device=device, max_epochs=epochs,
                      max_steps=args.max_steps, seed=args.seed, lr_schedule=lr_schedule,
                      hparams=hparams, checkpoint_every_epochs=args.checkpoint_every,
                      eval_every_epochs=args.val_every, metric_postprocess=metric_postprocess,
                      callbacks=callbacks)
    return trainer.fit(state, train_loader, val_loader, resume=not args.no_resume)


def _placed(module, device):
    memory_format = torch.channels_last if device.type == "cuda" else torch.preserve_format
    return module.to(device, memory_format=memory_format)


def run(args) -> TrainState:
    """Train ``args.recipe`` in this process: alone, or as one rank of the
    process group that torchrun's environment (or ``main``'s ``-d``)
    describes."""
    with process_group(args.device):
        return _run(args)


def _run(args) -> TrainState:
    recipe = RECIPES[args.recipe]
    # the JAX CLI's refusals of a flag that would do nothing
    if args.device_representation and recipe.kind == "ddpm":
        raise SystemExit("--device-representation is supported for EDM, consistency, distill, "
                         "autoencoder and classifier recipes")
    if args.cached_latents and not (recipe.latent and
                                    recipe.kind in ("edm", "consistency", "distill")):
        raise SystemExit("--cached-latents needs a latent EDM, consistency or distill recipe")
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(local_device(args.device))
    slices = args.num_slices or 1
    if world_size() > 1 or slices > 1:
        # the ranks' layout: data parallelism all-reduces over every axis of it
        mesh = make_hybrid_mesh(slices) if slices > 1 else make_mesh()
        logger.info("data parallel over %s", mesh)
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
        ae, enc_cfg, dec_cfg = common.build_autoencoder(config, dtype, dims=recipe.dims,
                                                        tiny=args.tiny, **_dropout(args))
        init_like_flax_(ae, args.seed)
        steps = make_autoencoder_steps(kl_weight=config.kl_weight, ema_decay=recipe.ema_decay,
                                       device_representation=device_rep)
        return _fit(recipe, args, config, device, _placed(ae, device), train_loader, val_loader,
                    steps, common.autoencoder_hparams(config, enc_cfg, dec_cfg), epochs)
    return _run_diffusion(recipe, args, config, device, dtype, batch, epochs, device_rep)


def _run_diffusion(recipe, args, config, device, dtype, batch, epochs, device_rep):
    """An EDM, consistency, distill or DDPM recipe: over the signal, or over a
    frozen autoencoder's latent."""
    ae, lat_path = None, None
    model_shape = common.signal_shape(config)
    if recipe.latent:
        ae, enc_cfg, _ = common.frozen_autoencoder(config, dtype, dims=recipe.dims,
                                                   tiny=args.tiny, weights=args.ae_weights,
                                                   ae_name=recipe.ae_name)
        model_shape = common.latent_shape(enc_cfg, model_shape)
        _placed(ae, device)
    if args.cached_latents:
        lat_path = latents_path(config, recipe.ae_name)
        if not lat_path.exists():
            raise SystemExit(f"{lat_path} not found — run `python -m "
                             f"tqdne_tpu_torch.cli.precompute_latents --workdir {args.workdir} "
                             f"--config {args.recipe}` first")
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
    # the sampling-eval callback's validation batches also carry the waveform targets
    val_keys = keys if "waveform" in keys else (*keys, "waveform")
    train_loader, val_loader, representation = common.make_loaders(
        config, batch, cond=True, device=device, keys=keys, val_keys=val_keys,
        host_representation=device_rep is None and lat_path is None, latents_path=lat_path)
    hparams = {"kind": recipe.kind, "dims": recipe.dims, "latent": recipe.latent,
               "ae_name": recipe.ae_name, "dtype": args.dtype}
    kw = dict(autoencoder=ae, latent_moments=lat_path is not None,
              device_representation=device_rep)
    if args.dropout is not None and recipe.network != "unet":
        raise SystemExit(f"--dropout: recipe {args.recipe!r}'s {recipe.network} has no dropout")
    unet, ucfg = common.build_network(recipe, config, model_shape[-1], dtype, tiny=args.tiny,
                                      **_dropout(args))
    init_like_flax_(unet, args.seed)
    if recipe.kind == "distill":
        # the EDM teacher's run (default: the run name with Distill -> EDM) at its stored
        # widths; teacher and student are two modules, the student starting from its weights
        name = args.teacher or recipe.name.replace("Distill", "EDM")
        weights, stored = common.run_checkpoint(config, name)
        ucfg = common.tuplify(stored["unet"]) | _dropout(args)
        teacher, unet = (set_compute_dtype(UNet(**ucfg), dtype) for _ in range(2))
        for module in (teacher, unet):
            module.load_state_dict(weights)
        steps = make_distillation_steps(_placed(teacher, device), ema_decay=args.ema_decay, **kw)
        hparams["teacher"] = name
    elif recipe.kind == "consistency":
        steps = make_consistency_steps(ConsistencyConfig(), _max_steps(args, epochs, train_loader),
                                       ema_decay=recipe.ema_decay, **kw)
    elif recipe.kind == "ddpm":
        steps = ddpm_lib.make_ddpm_steps(ddpm_lib.DDPMConfig(), ema_decay=recipe.ema_decay)
    else:
        steps = make_edm_steps(ema_decay=recipe.ema_decay, **kw)
    hparams[recipe.network] = ucfg
    callback = _sampling_eval(recipe, args, config, representation, val_loader, ae, model_shape,
                              device)
    return _fit(recipe, args, config, device, _placed(unet, device), train_loader, val_loader,
                steps, hparams, epochs, callbacks=(callback,))


def eval_sampler(kind: str, autoencoder, model_shape, device):
    """``(model, generator, batch) -> channels-last signal`` at the JAX step
    factories' defaults: the EDM kinds' Heun at 25 steps (49 evals), the
    consistency kinds' one eval from sigma_max and one refinement at sigma 1,
    DDPM's ``DDPMConfig`` timesteps; decoded by a latent recipe's frozen
    autoencoder."""
    def sample(model, generator, batch):
        cond = batch["cond"].to(device)
        shape = (len(cond), *model_shape)
        kw = dict(generator=generator, device=device)
        if kind == "ddpm":
            return ddpm_lib.ddpm_sample(ddpm_lib.DDPMConfig(), model, shape, cond=cond, **kw)
        kw["autoencoder"] = autoencoder
        if kind == "edm":
            return sample_edm(model, shape, cond, **kw)
        sampler = sample_consistency if kind == "consistency" else sample_distilled
        return sampler(model, shape, cond, **kw)

    return sample


def _eval_plots(config) -> list:
    """The JAX train CLI's figures of the sampling-eval callback: samples and
    ASD of each channel, then the per-bin ASD and the envelope and ASD grids;
    none where matplotlib is not installed (a GPU machine may lack it)."""
    if importlib.util.find_spec("matplotlib") is None:
        logger.warning("matplotlib is not installed: the sampling-eval callback writes no "
                       "figures")
        return []
    from tqdne_tpu_torch.eval import plots as P

    bins = configs.MAG_BINS, configs.DIST_BINS
    return ([P.SamplePlot(plot_target=True, fs=config.fs, channel=c)
             for c in range(WAVE_CHANNELS)]
            + [P.AmplitudeSpectralDensityPlot(fs=config.fs, channel=c)
               for c in range(WAVE_CHANNELS)]
            + [P.BinPlot(AmplitudeSpectralDensity(fs=config.fs, channel=0, isotropic=True), *bins),
               P.MovingAverageEnvelopeGrid(config.fs, 0, *bins),
               P.AmplitudeSpectralDensityGrid(config.fs, 0, *bins)])


def _sampling_eval(recipe, args, config, representation, val_loader, autoencoder, model_shape,
                   device) -> SamplingEvalCallback:
    """The JAX train CLI's sampling-eval callback over the first two
    validation batches, held on the host: the isotropic ASD of each channel,
    and the figures with the conditioning denormalised by the dataset's
    feature statistics."""
    val_batches = [{k: v.cpu() for k, v in b.items()}
                   for b in itertools.islice(val_loader, EVAL_BATCHES)]
    metrics = [AmplitudeSpectralDensity(fs=config.fs, channel=c, isotropic=True)
               for c in range(WAVE_CHANNELS)]
    return SamplingEvalCallback(
        eval_sampler(recipe.kind, autoencoder, model_shape, device), val_batches,
        representation, metrics=metrics, plots=_eval_plots(config),
        every_n_epochs=args.eval_every, feature_stats=common.dataset_feature_stats(config),
        features_keys=config.features_keys)


def _run_classifier(recipe, args, config, device, dtype, batch, epochs, device_rep):
    """Class weights from the ``train_validation`` split, validation on ``test``."""
    ds_rep = Identity() if device_rep is not None else config.make_representation()
    keys = ("waveform", "label") if device_rep is not None else ("signal", "label")

    def dataset(split):
        return ClassificationDataset(config.datapath, ds_rep, config.mag_bins, config.dist_bins,
                                     cut=config.t, split=split)

    ds_train, ds_val = dataset("train_validation"), dataset("test")
    train_loader = BatchLoader(ds_train, batch, device=device, keys=keys)
    val_loader = BatchLoader(ds_val, common.val_batch_size(batch, len(ds_val)), shuffle=False,
                             drop_last=True, device=device, keys=keys)
    enc_cfg = configs.get_classifier_encoder_config(config)
    if args.tiny:
        enc_cfg |= common.TINY_CLASSIFIER
    enc_cfg |= _dropout(args)
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
    for key, recipe in RECIPES.items():
        p = common.add_common_args(sub.add_parser(key))
        if recipe.kind == "distill":
            p.add_argument("--teacher", type=str, default=None,
                           help="the teacher's EDM run under outputs/ (default: the recipe's "
                                "run name with Distill -> EDM)")
            p.add_argument("--ema-decay", type=float, default=recipe.ema_decay,
                           help="CD target-network decay mu; the EMA is also the deployed "
                                "student")
    return launch(parser.parse_args(argv))


def launch(args) -> TrainState | None:
    """``run`` in this process (alone, or as the rank torchrun started), or,
    for ``-d N`` with N > 1 outside torchrun, in N local ranks started here
    over a free loopback port (then returns None).  ``-d`` must match
    torchrun's world size, and on ``cuda`` may not exceed the visible cards:
    a card is never shared."""
    n = args.num_devices
    if "WORLD_SIZE" in os.environ:
        if n is not None and n != int(os.environ["WORLD_SIZE"]):
            raise SystemExit(f"-d {n} under a launch of WORLD_SIZE={os.environ['WORLD_SIZE']} "
                             "ranks: pass the launch's world size, or leave -d out")
        return run(args)
    n = 1 if n is None else n
    if n < 1:
        raise SystemExit(f"-d {n}: at least one device")
    if n > 1 and torch.device(args.device).type == "cuda" and n > torch.cuda.device_count():
        raise SystemExit(f"-d {n} asks for {n} devices, but {torch.cuda.device_count()} CUDA "
                         "device(s) are visible; one rank drives one card")
    return common.run_ranks(run, args, n)


if __name__ == "__main__":
    main()
