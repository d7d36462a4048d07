"""Generate over a dataset split on a GPU and write everything the report
needs to HDF5: the port of ``tqdne_tpu/cli/evaluate.py`` for ``latent_edm``.

Per split it writes the five conditioning features plus eight datasets
(target/predicted waveform, target/predicted signal, target/predicted
classifier embedding, target/predicted classifier logits) and a
``provenance`` attribute, to ``<workdir>/evaluation/<run><suffix>-split_<split>-rank_0.h5``
(one process is rank 0 of 1):

    python -m tqdne_tpu_torch.cli.evaluate --workdir W --unet-weights unet.pt \\
        --ae-weights ae.pt --classifier-weights clf.pt \\
        --classifier-manifest weights/Classifier-LogSpectrogram-ema.manifest.json

Weights are ``.pt`` state dicts from ``python -m tqdne_tpu_torch.utils.convert``.
Without ``--classifier-weights`` the classifier is the port's own run
``outputs/<--classifier-name>`` in the workdir, built at its stored widths;
without either the classifier datasets are skipped.  The dataset is HDF5
and needs ``h5py``; ``evaluate_batch`` is the per-batch work without the
file.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from tqdne_tpu_torch import configs
from tqdne_tpu_torch.cli import common
from tqdne_tpu_torch.data.dataset import Dataset
from tqdne_tpu_torch.models.classifier import Classifier
from tqdne_tpu_torch.nn.layers import set_compute_dtype
from tqdne_tpu_torch.train.checkpoint import Checkpointer
from tqdne_tpu_torch.utils import fold_seed, resolve_device
from tqdne_tpu_torch.utils.convert import read_manifest


def load_classifier(weights=None, manifest=None, *, dtype=torch.bfloat16, device="cuda",
                    init_seed: int = 0):
    """The classifier on ``device``, computing in ``dtype`` over f32
    parameters.  The encoder's widths come from the artifact's ``manifest``
    (``utils.convert.read_manifest``) or, without one, the preset; the
    weights from a ``.pt`` state dict, loaded strictly, or seeded random ones
    when ``weights`` is None."""
    config = configs.SpectrogramClassificationConfig()
    if manifest is not None:
        hparams = read_manifest(manifest)
        enc_cfg, num_classes = hparams["encoder"], int(hparams["num_classes"])
    else:
        enc_cfg, num_classes = configs.get_classifier_encoder_config(config), config.num_classes
    device = resolve_device(device)
    classifier = set_compute_dtype(Classifier(enc_cfg, num_classes), dtype)
    common.load_weights(classifier, weights, init_seed)
    classifier.to(device).eval()
    if device.type == "cuda":
        classifier.to(memory_format=torch.channels_last)
    return classifier


def load_classifier_run(workdir, name: str, *, dtype=torch.bfloat16, device="cuda"):
    """The classifier of the port's run ``outputs/<name>`` (its latest
    checkpoint's EMA weights, the encoder at the widths its
    ``hparams.json`` stores, else the preset), on ``device``, computing in
    ``dtype``; None when the run has no checkpoint."""
    config = configs.SpectrogramClassificationConfig(workdir=workdir)
    ckpt = Checkpointer(config.outputdir / name / "checkpoints")
    restored = ckpt.restore_latest_raw()
    if restored is None:
        return None
    stored = ckpt.restore_hyperparameters() or {}
    if "encoder" in stored:
        enc_cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in stored["encoder"].items()}
        num_classes = int(stored.get("num_classes", config.num_classes))
    else:
        enc_cfg, num_classes = configs.get_classifier_encoder_config(config), config.num_classes
    device = resolve_device(device)
    classifier = set_compute_dtype(Classifier(enc_cfg, num_classes), dtype)
    classifier.load_state_dict(restored[0]["ema"])
    classifier.to(device).eval()
    if device.type == "cuda":
        classifier.to(memory_format=torch.channels_last)
    return classifier


@torch.no_grad()
def evaluate_batch(bundle, classifier, batch: dict, generator: torch.Generator,
                   batch_size: int | None = None) -> dict:
    """One batch of the evaluation: conditioning ``batch["cond"]`` (n, 5),
    padded to ``batch_size`` for sampling, gives the predicted signal
    (n, C, F, frames) and waveform (n, 3, t); with a classifier, the target
    ``batch["signal"]`` (n, C, F, frames) and the predicted signal give the
    embeddings and logits.  Tensors on the bundle's device, f32."""
    n = len(batch["cond"])
    signal = bundle.sample(bundle.padded_cond(batch["cond"], batch_size or n),
                           generator=generator)
    out = {"predicted_signal": signal.movedim(-1, 1)[:n],
           "predicted_waveform": bundle.invert(signal, generator=generator)[:n]}
    if classifier is not None:
        target = torch.as_tensor(batch["signal"]).to(bundle.device).movedim(1, -1)
        t_emb, t_logits = classifier.embed_and_logits(target)
        p_emb, p_logits = classifier.embed_and_logits(signal)
        out |= {"target_classifier_embedding": t_emb, "target_classifier_pred": t_logits,
                "predicted_classifier_embedding": p_emb[:n],
                "predicted_classifier_pred": p_logits[:n]}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser("tqdne_tpu_torch.cli.evaluate",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--workdir", type=str, required=True)
    parser.add_argument("--config", type=str, default="latent_edm")
    parser.add_argument("--split", type=str, default="test",
                        choices=["train", "validation", "test", "train_validation", "full"])
    parser.add_argument("-b", "--batchsize", type=int, default=32)
    parser.add_argument("--name", type=str, default=None,
                        help=f"run name of the output file (default: {common.RUN_NAME})")
    parser.add_argument("--unet-weights", type=str, required=True,
                        help="UNet state dict (.pt) from tqdne_tpu_torch.utils.convert")
    parser.add_argument("--ae-weights", type=str, required=True,
                        help="autoencoder state dict (.pt) from tqdne_tpu_torch.utils.convert")
    parser.add_argument("--classifier-name", type=str, default="Classifier-LogSpectrogram",
                        help="the classifier's run under outputs/, read when no "
                             "--classifier-weights is given")
    parser.add_argument("--classifier-weights", type=str, default=None,
                        help="classifier state dict (.pt) from tqdne_tpu_torch.utils.convert")
    parser.add_argument("--classifier-manifest", type=str, default=None,
                        help="the classifier artifact's manifest.json (its widths; default: "
                             "the preset)")
    parser.add_argument("--no-classifier", action="store_true",
                        help="skip classifier embedding/logit datasets")
    parser.add_argument("--num_steps", "--num-steps", type=int, default=25)
    parser.add_argument("--solver", type=str, default="heun", choices=["heun", "dpmpp_2m"])
    parser.add_argument("--dtype", type=str, default="bf16", choices=["f32", "bf16"])
    parser.add_argument("--limit-batches", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tiny", action="store_true",
                        help="match a --tiny-trained run's model widths")
    parser.add_argument("--suffix", type=str, default="",
                        help="appended to the output filename")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    import h5py

    dtype = common.parse_dtype(args.dtype)
    bundle = common.build_inference(
        args.config, unet_weights=args.unet_weights, ae_weights=args.ae_weights, dtype=dtype,
        num_steps=args.num_steps, solver=args.solver, device=args.device, tiny=args.tiny)
    config = configs.LatentSpectrogramConfig(workdir=args.workdir)
    run_name = args.name or common.RUN_NAME
    dataset = Dataset(config.datapath, bundle.representation, cut=config.t, cond=True,
                      split=args.split)

    classifier = None
    if not args.no_classifier:
        if args.classifier_weights is not None:
            classifier = load_classifier(
                args.classifier_weights, args.classifier_manifest, dtype=dtype,
                device=bundle.device)
        else:
            classifier = load_classifier_run(args.workdir, args.classifier_name, dtype=dtype,
                                             device=bundle.device)
            if classifier is None:
                print(f"no classifier checkpoint for {args.classifier_name} — skipping "
                      "embedding/logit datasets (--no-classifier to silence)")

    bs = args.batchsize
    all_idx = np.arange(len(dataset))  # rank 0 of 1
    if args.limit_batches:
        all_idx = all_idx[: args.limit_batches * bs]
    outdir = Path(args.workdir) / "evaluation"
    outdir.mkdir(parents=True, exist_ok=True)
    outfile = outdir / f"{run_name}{args.suffix}-split_{args.split}-rank_0.h5"

    n, t = len(all_idx), bundle.t
    sig_shape = common.signal_shape(config)
    sig_cf = (sig_shape[-1], *sig_shape[:-1])
    with h5py.File(outfile, "w") as f:
        # provenance: which weights were sampled and the sampler's settings,
        # copied into the report JSON by eval.report; the last two fields are
        # the JAX CLI's consistency settings, at its defaults
        f.attrs["provenance"] = json.dumps(
            {"run_name": run_name, "recipe": args.config, "unet_weights": args.unet_weights,
             "ae_weights": args.ae_weights, "num_steps": args.num_steps,
             "solver": args.solver, "seed": args.seed, "dtype": args.dtype,
             "split": args.split, "consistency_noise": "auto", "refine_sigma": 1.0})
        for key in config.features_keys:
            f.create_dataset(key, data=dataset.get_feature(key)[all_idx])
        dsets = {
            "target_waveform": (n, 3, t),
            "predicted_waveform": (n, 3, t),
            "target_signal": (n, *sig_cf),
            "predicted_signal": (n, *sig_cf),
        }
        if classifier is not None:
            width, classes = classifier.head.in_features, classifier.head.out_features
            dsets |= {
                "target_classifier_embedding": (n, width),
                "predicted_classifier_embedding": (n, width),
                "target_classifier_pred": (n, classes),
                "predicted_classifier_pred": (n, classes),
            }
        handles = {k: f.create_dataset(k, shape=shape, dtype="f") for k, shape in dsets.items()}

        for start in range(0, n, bs):
            idx = all_idx[start : start + bs]
            batch = dataset.load_batch(idx)
            generator = torch.Generator(device=bundle.device).manual_seed(
                fold_seed(args.seed, start))
            out = evaluate_batch(bundle, classifier, batch, generator, bs)
            end = start + len(idx)
            handles["target_waveform"][start:end] = batch["waveform"][..., :t]
            handles["target_signal"][start:end] = batch["signal"]
            for key, value in out.items():
                handles[key][start:end] = value.cpu().numpy()
            print(f"{end}/{n}")
    print(f"wrote {outfile}")


if __name__ == "__main__":
    main()
