"""Reference Lightning ``.ckpt`` -> a port run: the port of
``tqdne_tpu/cli/import_checkpoint.py``.

Converts a reference checkpoint (the released Zenodo weights, records
15687691 / 16405538, or any of the same layout) into the port's own
checkpoint format under ``<workdir>/outputs/<name>/checkpoints``
(``train/checkpoint.py``): the step from ``global_step``, the live weights
from ``state_dict``, the EMA weights from the EMA callback's ``ema_state``
(at the top level or under ``callbacks``; the live weights where there is
none), a fresh optimizer of the recipe, and ``hparams.json`` at the widths
imported.  ``build_inference``, the evaluate CLI, the sampling-eval callback
and a resume then read the run as they read a trained one:

    python -m tqdne_tpu_torch.cli.import_checkpoint edm --ckpt edm.ckpt --workdir W
    python -m tqdne_tpu_torch.cli.import_checkpoint autoencoder --ckpt ae.ckpt --workdir W
    python -m tqdne_tpu_torch.cli.import_checkpoint classifier --ckpt clf.ckpt --workdir W

``--verify`` rebuilds the reference's own PyTorch modules (the ``tqdne``
package) from the checkpoint and holds the port's forward against them;
without that package it refuses.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import torch

from tqdne_tpu_torch import configs
from tqdne_tpu_torch.cli import common
from tqdne_tpu_torch.models.classifier import Classifier
from tqdne_tpu_torch.models.unet import UNet
from tqdne_tpu_torch.train.checkpoint import Checkpointer
from tqdne_tpu_torch.train.state import TrainState, make_optimizer
from tqdne_tpu_torch.utils.torch_convert import (
    convert_autoencoder,
    convert_classifier,
    convert_unet,
    ema_state_dict,
    read_checkpoint,
    strip_prefix,
)

KINDS = {"edm": "latent_edm", "autoencoder": "autoencoder", "classifier": "classifier"}
TOL = 1e-4  # --verify: the largest error relative to max(|reference|, 1e-3)


def _reference_modules():
    """The reference package's modules; SystemExit without it."""
    try:
        from tqdne.blocks import Decoder, Encoder
        from tqdne.unet import UNetModel
    except ImportError as e:
        raise SystemExit("--verify needs the reference 'tqdne' PyTorch package on the path "
                         f"(pip install tqdne); not verified: {e}") from e
    return UNetModel, Encoder, Decoder


@torch.no_grad()
def verify_conversion(kind: str, base_sd: dict, module: torch.nn.Module, cfgs, tol: float = TOL):
    """The port's ``module`` (holding the converted ``base_sd``) against the
    reference's own module loaded with ``base_sd``, in f32 on the CPU on a
    seeded input: the UNet forward, the autoencoder's encoder moments and
    decoder, the classifier's logits.  SystemExit on an error above ``tol``
    relative to max(|reference|, 1e-3)."""
    UNetModel, Encoder, Decoder = _reference_modules()

    def check(got, want, what):
        rel = ((got - want).abs() / want.abs().clamp(min=1e-3)).max().item()
        print(f"verify[{kind}/{what}]: max rel err {rel:.3e} (tol {tol:g})")
        if rel > tol:
            raise SystemExit(f"--verify FAILED for {kind}/{what}: {rel:.3e} > {tol:g}")

    gen = torch.Generator().manual_seed(0)
    module.eval()
    if kind == "edm":
        ref = UNetModel(**cfgs, flash_attention=False).eval()
        ref.load_state_dict(base_sd, strict=True)
        x = torch.randn(2, cfgs["in_channels"], 32, 32, generator=gen)
        t = torch.randn(2, generator=gen)
        cond = torch.randn(2, cfgs["cond_features"], generator=gen)
        check(module(x.movedim(1, -1), t, cond).movedim(-1, 1), ref(x, t, cond), "unet_forward")
    elif kind == "autoencoder":
        enc_cfg, dec_cfg = cfgs
        ref_enc = Encoder(**enc_cfg, flash_attention=False).eval()
        ref_dec = Decoder(**dec_cfg, flash_attention=False).eval()
        ref_enc.load_state_dict(strip_prefix(base_sd, "encoder"), strict=True)
        ref_dec.load_state_dict(strip_prefix(base_sd, "decoder"), strict=True)
        x = torch.randn(1, enc_cfg["in_channels"], 128, 128, generator=gen)
        mean, log_std = module.moments(x.movedim(1, -1))
        check(torch.cat([mean, log_std], dim=-1).movedim(-1, 1), ref_enc(x), "encoder_moments")
        z = torch.randn(1, dec_cfg["in_channels"], 32, 32, generator=gen)
        check(module.decode(z.movedim(1, -1)).movedim(-1, 1), ref_dec(z), "decoder")
    else:
        ref_enc = Encoder(**cfgs, flash_attention=False).eval()
        ref_enc.load_state_dict(strip_prefix(base_sd, "encoder"), strict=True)
        x = torch.randn(2, cfgs["in_channels"], 64, 64, generator=gen)
        # the reference head: SiLU -> Linear -> SiLU -> Linear -> output layer
        w = base_sd
        silu, linear = torch.nn.functional.silu, torch.nn.functional.linear
        h = ref_enc(x).mean(dim=(2, 3))
        emb = linear(silu(linear(silu(h), w["output_MLP.1.weight"], w["output_MLP.1.bias"])),
                     w["output_MLP.3.weight"], w["output_MLP.3.bias"])
        want = linear(emb, w["output_layer.weight"], w["output_layer.bias"])
        check(module(x.movedim(1, -1)), want, "classifier_logits")


def _architecture(kind: str, sd: dict, workdir, model_channels: int | None, tiny: bool):
    """(the port's module, the converter into it, its hparams, the reference
    configs for --verify) of ``kind`` at the preset widths; ``tiny``: the
    train CLI's ``--tiny`` widths; ``model_channels``: the UNet's width (the
    JAX import's own override)."""
    if kind == "edm":
        config = configs.LatentSpectrogramConfig(workdir=workdir)
        ucfg = configs.get_2d_unet_config(config, config.latent_channels, config.latent_channels)
        if tiny:
            ucfg["model_channels"] = common.TINY_CHANNELS
        if model_channels:
            ucfg["model_channels"] = model_channels
        hparams = {"kind": "edm", "dims": 2, "latent": True, "ae_name": common.AE_NAME,
                   "dtype": "bf16", "unet": ucfg}
        return UNet(**ucfg), (lambda s: convert_unet(s, ucfg)), hparams, ucfg
    if kind == "autoencoder":
        config = configs.LatentSpectrogramConfig(workdir=workdir)
        ae, enc_cfg, dec_cfg = common.build_autoencoder(config, tiny=tiny)
        return (ae, (lambda s: convert_autoencoder(s, enc_cfg, dec_cfg)),
                common.autoencoder_hparams(config, enc_cfg, dec_cfg), (enc_cfg, dec_cfg))
    config = configs.SpectrogramClassificationConfig(workdir=workdir)
    enc_cfg = configs.get_classifier_encoder_config(config)
    if tiny:
        enc_cfg |= common.TINY_CLASSIFIER
    num_classes = int(sd["output_layer.weight"].shape[0])
    hparams = {"kind": "classifier", "encoder": enc_cfg, "num_classes": num_classes}
    return (Classifier(enc_cfg, num_classes), (lambda s: convert_classifier(s, enc_cfg)),
            hparams, enc_cfg)


def import_checkpoint(kind: str, ckpt_path, workdir, name: str | None = None,
                      model_channels: int | None = None, verify: bool = False,
                      tiny: bool = False) -> Path:
    """Import a reference checkpoint of ``kind`` (``edm``, ``autoencoder`` or
    ``classifier``) as the port's run ``outputs/<name>`` (default: the
    recipe's run name); returns its checkpoint directory."""
    if kind not in KINDS:
        raise SystemExit(f"unknown kind {kind!r} (have: {', '.join(KINDS)})")
    if verify:
        _reference_modules()  # refuse before converting anything
    recipe = common.RECIPES[KINDS[kind]]
    ckpt = read_checkpoint(ckpt_path)
    sd = dict(ckpt["state_dict"])
    step = int(ckpt.get("global_step", 0))
    prefix = "unet" if kind == "edm" else ""
    base = strip_prefix(sd, prefix) if prefix else sd
    ema_sd = ema_state_dict(ckpt, base, prefix)
    model, convert, hparams, cfgs = _architecture(kind, base, workdir, model_channels, tiny)
    model.load_state_dict(convert(base))
    optimizer = make_optimizer(recipe.optimizer, model, 1e-4, recipe.weight_decay)
    state = TrainState(model, optimizer)
    state.step = step
    if ema_sd is not None:
        state.ema.load_state_dict(convert(ema_sd))
    if verify:
        verify_conversion(kind, base, model, cfgs)
        if ema_sd is not None:
            verify_conversion(kind, ema_sd, state.ema, cfgs)

    config = recipe.config_cls(workdir=workdir)
    ckpt_mgr = Checkpointer(Path(config.outputdir) / (name or recipe.name) / "checkpoints")
    ckpt_mgr.save(step, state)
    ckpt_mgr.save_hyperparameters(hparams)
    print(f"imported {kind} checkpoint (step {step}, EMA {'found' if ema_sd else 'absent'}) "
          f"-> {ckpt_mgr.directory}")
    return ckpt_mgr.directory


def main(argv=None):
    parser = argparse.ArgumentParser("tqdne_tpu_torch.cli.import_checkpoint",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("kind", choices=list(KINDS))
    parser.add_argument("--ckpt", required=True, help="reference Lightning .ckpt path")
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--name", default=None, help="run name (default: the recipe's)")
    parser.add_argument("--tiny", action="store_true",
                        help="the train CLI's --tiny widths (32-channel UNet and autoencoder, "
                             "16-channel classifier)")
    parser.add_argument("--verify", action="store_true",
                        help="after conversion, rebuild the reference's PyTorch modules from "
                             "the checkpoint and hold the port's forward to 1e-4 on a seeded "
                             "input (needs the 'tqdne' package)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    import_checkpoint(args.kind, args.ckpt, args.workdir, args.name, verify=args.verify,
                      tiny=args.tiny)


if __name__ == "__main__":
    main()
