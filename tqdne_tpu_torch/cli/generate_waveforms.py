"""Sample accelerograms from a diffusion recipe on a GPU.

The port of ``tqdne_tpu/cli/generate_waveforms.py`` for the EDM recipes
``latent_edm`` (default), ``latent_dit``, ``edm``, ``1d_edm`` and ``1d_latent_edm``, the
few-eval ``consistency``, ``latent_consistency`` and ``latent_distill``, and
``ddpm`` (``--config``): conditioning from flags or a CSV
(hypocentral_distance, magnitude, vs30, hypocentre_depth, azimuthal_gap[,
num_samples] per row), normalised with the published dataset summary
statistics, batched sampling, the inversion (Griffin-Lim for a spectrogram,
the elementwise inverse for the envelope) and the same HDF5 layout (one
dataset per feature plus ``waveforms`` (N, 3, T)).  ``--solver consistency``
or ``distill`` routes ``latent_edm`` to ``latent_consistency`` or
``latent_distill`` and refuses another EDM recipe; ``--num_steps`` counts the
network evals of a few-eval recipe (default 2) or the EDM ODE's steps
(default 25).  Weights are ``.pt`` state dicts written by ``python -m
tqdne_tpu_torch.utils.convert``, the reference's Lightning checkpoints
converted on the fly (``--edm-checkpoint`` with ``--autoencoder-checkpoint``),
an exported artifact (``--weights``, digest-checked), or the port's own runs
in ``--workdir`` (``--name``, ``--ae-name``):

    python -m tqdne_tpu_torch.cli.generate_waveforms --csv examples/demo_conditioning.csv \\
        --unet-weights unet.pt --ae-weights ae.pt --outfile out.h5 --device cuda
    python -m tqdne_tpu_torch.cli.generate_waveforms --solver distill --workdir W \\
        --csv examples/demo_conditioning.csv --outfile out.h5
    python -m tqdne_tpu_torch.cli.generate_waveforms --edm-checkpoint edm.ckpt \\
        --autoencoder-checkpoint ae.ckpt --csv examples/demo_conditioning.csv --outfile out.h5

``--int8`` runs the sampler's convolutions in the int8 mode (``nn.quant``).
``--spatial K`` (EDM recipes) splits each sample's first spatial axis K ways
over a ``("data", "model")`` mesh (``parallel.spatial``): under torchrun over
its ranks, else over K ranks the CLI starts itself (sharing the card over
gloo where there are fewer cards); rank 0 writes the file.
"""

from __future__ import annotations

import argparse
import contextlib
import csv as csv_mod
from pathlib import Path

import numpy as np
import torch

from tqdne_tpu_torch.cli import common
from tqdne_tpu_torch.cli.common import RECIPES
from tqdne_tpu_torch.configs import FEATURES_KEYS
from tqdne_tpu_torch.parallel import rank

# dataset conditioning-feature summary statistics (mean, std), in FEATURES_KEYS order
SUMMARY_STATISTICS = np.array(
    [
        [101.29891904350877, 40.78415968551517],  # hypocentral_distance
        [4.801697862929673, 0.7146698731358634],  # magnitude
        [384.7045105848187, 220.11269086015872],  # vs30
        [38.359214998072, 22.472499592355014],  # hypocentre_depth
        [129.92139043457396, 89.69479051949207],  # azimuthal_gap
    ]
)


def read_conditioning(args) -> np.ndarray:
    """Rows of raw (unnormalised) features, one per waveform to generate."""
    if args.csv:
        rows = []
        with open(args.csv) as f:
            reader = csv_mod.DictReader(f)
            missing = [k for k in FEATURES_KEYS if k not in (reader.fieldnames or ())]
            if missing:
                raise SystemExit(f"CSV {args.csv} is missing required columns: "
                                 f"{', '.join(missing)}")
            for row in reader:
                n = int(float(row.get("num_samples", 1)))
                rows.extend([[float(row[k]) for k in FEATURES_KEYS]] * n)
        return np.array(rows, np.float64)
    values = [getattr(args, k) for k in FEATURES_KEYS]
    if any(v is None for v in values) or args.num_samples is None:
        raise SystemExit("provide either --csv or a full parameter set with --num_samples")
    return np.tile(np.array(values, np.float64), (args.num_samples, 1))


def normalize(cond_raw: np.ndarray) -> np.ndarray:
    return (cond_raw - SUMMARY_STATISTICS[:, 0]) / SUMMARY_STATISTICS[:, 1]


def main(argv=None):
    parser = argparse.ArgumentParser("tqdne_tpu_torch.cli.generate_waveforms",
                                     description=__doc__.split("\n\n")[0])
    for k in FEATURES_KEYS:
        parser.add_argument(f"--{k}", type=float, default=None)
    parser.add_argument("--num_samples", "--num-samples", type=int, default=None)
    parser.add_argument("--csv", type=str, default=None)
    parser.add_argument("--outfile", type=str, required=True)
    parser.add_argument("--config", type=str, default="latent_edm",
                        help="recipe: latent_edm, latent_dit, edm, 1d_edm, 1d_latent_edm, "
                             "consistency, latent_consistency, latent_distill or ddpm")
    parser.add_argument("--workdir", type=str, default=None,
                        help="read each model without a weights file from the port's run here")
    parser.add_argument("--name", type=str, default=None,
                        help="run name under outputs/ (default: the recipe's run name)")
    parser.add_argument("--ae-name", type=str, default=None,
                        help="the frozen autoencoder's run name (default: the recipe's)")
    parser.add_argument("--edm-checkpoint", "--edm_checkpoint", type=str, default=None,
                        help="reference Lightning EDM .ckpt (converted on the fly)")
    parser.add_argument("--autoencoder-checkpoint", "--autoencoder_checkpoint", type=str,
                        default=None, help="reference Lightning autoencoder .ckpt")
    parser.add_argument("--weights", type=str, default=None,
                        help="UNet EMA weights from an exported artifact (.msgpack, "
                             "digest-checked against its manifest; cli.export_weights)")
    parser.add_argument("--stats-from-dataset", action="store_true",
                        help="normalize conditioning with the workdir dataset's feature "
                             "statistics instead of the published summary table")
    parser.add_argument("--unet-weights", type=str, default=None,
                        help="UNet state dict (.pt) from tqdne_tpu_torch.utils.convert")
    parser.add_argument("--ae-weights", type=str, default=None,
                        help="latent recipes: the autoencoder's state dict (.pt)")
    parser.add_argument("--batch_size", "--batch-size", type=int, default=32)
    parser.add_argument("--num_steps", "--num-steps", type=int, default=None,
                        help="sampling steps (default 25), or network evals of a few-eval "
                             "recipe (default 2)")
    parser.add_argument("--solver", type=str, default="heun",
                        choices=["heun", "dpmpp_2m", "consistency", "distill"],
                        help="heun = reference semantics (2N-1 UNet evals); dpmpp_2m = "
                             "2nd-order multistep, N evals; consistency / distill = 1-2 eval "
                             "sampling of a consistency or distilled run (latent_edm routes to "
                             "latent_consistency / latent_distill)")
    parser.add_argument("--consistency-noise", type=str, default="auto",
                        choices=list(common.CONSISTENCY_NOISE),
                        help="few-eval sampling convention: auto (= song), song or reference")
    parser.add_argument("--dtype", type=str, default="bf16", choices=["f32", "bf16"])
    parser.add_argument("--gl-iters", type=int, default=None,
                        help="Griffin-Lim iterations of a spectrogram recipe (default: the "
                             "representation's 128)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--tiny", action="store_true",
                        help="match weights of the 32-channel --tiny widths")
    parser.add_argument("--spatial", type=int, default=0,
                        help="EDM recipes: split each sample's first spatial axis K ways over "
                             "a (data, model) mesh of the launched ranks (torchrun's, else K "
                             "started here); K must divide the ranks")
    parser.add_argument("--int8", action="store_true",
                        help="quality-gated fast mode: the sampler's convolutions in int8 "
                             "(per-channel weights, per-tensor activations, int32 sums)")
    args = parser.parse_args(argv)
    args.config, args.num_steps = common.route_solver(args.config, args.solver, args.num_steps)

    if bool(args.edm_checkpoint) != bool(args.autoencoder_checkpoint):
        raise SystemExit("either both or none of the torch checkpoints must be provided")
    latent = getattr(RECIPES.get(args.config), "latent", False)
    unet_given = args.unet_weights or args.edm_checkpoint or args.weights
    ae_given = args.ae_weights or args.autoencoder_checkpoint
    if args.workdir is None and (not unet_given or latent and not ae_given):
        raise SystemExit("give the weights files (--unet-weights, --edm-checkpoint or --weights, "
                         "and --ae-weights or --autoencoder-checkpoint for a latent recipe) or "
                         "the --workdir of the runs")
    common.refuse_options(args.config, int8=args.int8, spatial=args.spatial)
    if args.spatial > 1 and getattr(RECIPES.get(args.config), "kind", None) != "edm":
        raise SystemExit(f"--spatial serves EDM recipes only (got --config {args.config})")
    common.run_ranks(generate, args, args.spatial)


def generate(args):
    """``main``'s sampling on this rank (rank 0 writes the file)."""
    cond_raw = read_conditioning(args)
    bundle = common.build_inference(
        args.config, workdir=args.workdir, unet_weights=args.unet_weights,
        ae_weights=args.ae_weights, run_name=args.name, ae_name=args.ae_name,
        edm_checkpoint=args.edm_checkpoint, autoencoder_checkpoint=args.autoencoder_checkpoint,
        exported_weights=args.weights, dtype=common.DTYPES[args.dtype],
        num_steps=args.num_steps, solver=args.solver, gl_iters=args.gl_iters,
        device=common.rank_device(args.device), tiny=args.tiny,
        consistency_noise=args.consistency_noise, int8=args.int8, spatial=args.spatial)
    if args.stats_from_dataset:
        stats = common.dataset_feature_stats(bundle.config)
        cond_norm = (cond_raw - stats[:, 0]) / stats[:, 1]
    else:
        cond_norm = normalize(cond_raw)
    cond = torch.as_tensor(cond_norm, dtype=torch.float32)
    generator = torch.Generator(device=bundle.device).manual_seed(args.seed)

    n, bs = len(cond), args.batch_size
    # a spatial mesh's data ranks split each batch: a short last one gets zero rows
    rows = bundle.mesh.size(0) if bundle.mesh is not None else 1
    with contextlib.ExitStack() as stack:
        waveforms = None
        if rank() == 0:
            import h5py

            outfile = Path(args.outfile)
            outfile.parent.mkdir(parents=True, exist_ok=True)
            f = stack.enter_context(h5py.File(outfile, "w"))
            for i, k in enumerate(FEATURES_KEYS):
                f.create_dataset(k, data=cond_raw[:, i])
            waveforms = f.create_dataset("waveforms", (n, 3, bundle.t), dtype=np.float32)
        for start in range(0, n, bs):
            batch = cond[start : start + bs]
            pad = -len(batch) % rows
            if pad:
                batch = torch.cat([batch, batch.new_zeros(pad, batch.shape[1])])
            wave = bundle.generate(batch, generator=generator)[: len(batch) - pad]
            if waveforms is not None:
                waveforms[start : start + len(wave)] = wave.cpu().numpy()
                print(f"generated {min(start + bs, n)}/{n}")
    if rank() == 0:
        print("done!")


if __name__ == "__main__":
    main()
