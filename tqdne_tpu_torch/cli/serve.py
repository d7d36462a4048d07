"""Long-lived HTTP generation service on a GPU: the port of
``tqdne_tpu/cli/serve.py`` for every diffusion recipe (``--config``): the EDM
recipes ``latent_edm`` (default), ``latent_dit``, ``edm``, ``1d_edm`` and ``1d_latent_edm``
(``--solver heun`` or ``dpmpp_2m``), the few-eval ``consistency``,
``latent_consistency`` and ``latent_distill`` (``--solver consistency`` or
``distill`` routes ``latent_edm`` to them; 2 network evals unless
``--num-steps`` says otherwise) and ``ddpm``.

Builds the same ``InferenceBundle`` as ``cli.generate_waveforms``, keeps the
weights on the device, warms the sampler up (the first call builds the CUDA
kernels with nvcc and picks cuDNN's algorithms) and then serves coalesced
micro-batches over HTTP (``tqdne_tpu_torch/serving.py``):

    python -m tqdne_tpu_torch.cli.serve --unet-weights unet.pt --ae-weights ae.pt --port 8000
    python -m tqdne_tpu_torch.cli.serve --solver distill --workdir W --port 8000
    curl -s localhost:8000/generate -d '{"conditions": [{"hypocentral_distance": 50,
      "magnitude": 5.5, "vs30": 400, "hypocentre_depth": 20, "azimuthal_gap": 100}]}'

Each model without a weights file comes from the port's run in ``--workdir``;
without either it takes seeded random weights (smoke runs).  Griffin-Lim
runs 32 iterations unless ``--gl-iters`` says otherwise; the envelope
recipes have no Griffin-Lim and refuse the flag.

``--int8`` runs the sampler's convolutions in the int8 mode (``nn.quant``).
``--spatial K`` (EDM recipes) splits each sample's first spatial axis K ways
over a ``("data", "model")`` mesh of the launched ranks (torchrun's, or K the
CLI starts, sharing the card over gloo where there are fewer cards).  Rank 0
owns the HTTP server and the micro-batcher; its device owner broadcasts each
batch (its seed and conditioning rows) to the other ranks, which run the
same sampler and join its collectives (``follow``), and a stop on shutdown.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from tqdne_tpu_torch import serving
from tqdne_tpu_torch.cli import common
from tqdne_tpu_torch.cli.generate_waveforms import SUMMARY_STATISTICS
from tqdne_tpu_torch.cli.common import RECIPES
from tqdne_tpu_torch.parallel import broadcast_, rank

logger = logging.getLogger("tqdne_tpu_torch.serve")

SERVE_GL_ITERS = 32  # the JAX package's measured knee (128 for the reference's)


def parse_args(argv=None):
    parser = argparse.ArgumentParser("tqdne_tpu_torch.cli.serve",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--workdir", type=str, default=None,
                        help="working directory: each model without a weights file comes "
                             "from the port's run here, and its dataset feeds "
                             "--stats-from-dataset")
    parser.add_argument("--config", type=str, default="latent_edm",
                        help="recipe: latent_edm, latent_dit, edm, 1d_edm, 1d_latent_edm, "
                             "consistency, latent_consistency, latent_distill or ddpm")
    parser.add_argument("--name", type=str, default=None,
                        help="run name under outputs/ (default: the recipe's run name)")
    parser.add_argument("--ae-name", type=str, default=None,
                        help="the frozen autoencoder's run name (default: the recipe's)")
    parser.add_argument("--unet-weights", type=str, default=None,
                        help="UNet state dict (.pt) from tqdne_tpu_torch.utils.convert "
                             "(default: seeded random weights)")
    parser.add_argument("--ae-weights", type=str, default=None,
                        help="autoencoder state dict (.pt) from tqdne_tpu_torch.utils.convert "
                             "(default: seeded random weights)")
    parser.add_argument("--solver", type=str, default="heun",
                        choices=["heun", "dpmpp_2m", "consistency", "distill"])
    parser.add_argument("--num_steps", "--num-steps", type=int, default=None,
                        help="sampling steps (default 25), or network evals of a few-eval "
                             "recipe (default 2)")
    parser.add_argument("--consistency-noise", type=str, default="auto",
                        choices=list(common.CONSISTENCY_NOISE),
                        help="few-eval sampling convention: auto (= song), song or reference")
    parser.add_argument("--batch_size", "--batch-size", type=int, default=32,
                        help="device batch size: requests are padded/coalesced to it")
    parser.add_argument("--max-delay-ms", type=float, default=15.0,
                        help="micro-batching window: how long a partial batch "
                             "waits for more requests before launching")
    parser.add_argument("--dtype", type=str, default="bf16", choices=["f32", "bf16"])
    parser.add_argument("--gl-iters", type=int, default=None,
                        help=f"Griffin-Lim iterations of a spectrogram recipe (default "
                             f"{SERVE_GL_ITERS}, the JAX package's measured knee; 128 for the "
                             f"reference's)")
    parser.add_argument("--tiny", action="store_true",
                        help="32-channel UNet and autoencoder")
    parser.add_argument("--stats-from-dataset", action="store_true",
                        help="normalize conditioning with the workdir dataset's stats "
                             "instead of the published summary table")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--spatial", type=int, default=0,
                        help="EDM recipes: split each sample's first spatial axis K ways over "
                             "a (data, model) mesh of the launched ranks (torchrun's, else K "
                             "started here); rank 0 serves")
    parser.add_argument("--int8", action="store_true",
                        help="quality-gated fast mode: the sampler's convolutions in int8")
    args = parser.parse_args(argv)
    args.config, args.num_steps = common.route_solver(args.config, args.solver, args.num_steps)
    common.refuse_options(args.config, int8=args.int8, spatial=args.spatial)
    if args.spatial > 1 and getattr(RECIPES.get(args.config), "kind", None) != "edm":
        raise SystemExit(f"--spatial serves EDM recipes only (got --config {args.config})")
    return args


def build_bundle(args):
    """The ``InferenceBundle`` the server samples, on this rank's device."""
    recipe = RECIPES.get(args.config)
    gl_iters = args.gl_iters
    if gl_iters is None and hasattr(getattr(recipe, "config_cls", None), "griffin_lim_iters"):
        gl_iters = SERVE_GL_ITERS
    return common.build_inference(
        args.config, workdir=args.workdir, unet_weights=args.unet_weights,
        ae_weights=args.ae_weights, run_name=args.name, ae_name=args.ae_name,
        dtype=common.parse_dtype(args.dtype),
        num_steps=args.num_steps, solver=args.solver, gl_iters=gl_iters,
        device=common.rank_device(args.device), tiny=args.tiny,
        consistency_noise=args.consistency_noise, int8=args.int8, spatial=args.spatial)


def _batch_message(batch_size: int, seed: int = 0, cond=None, go: bool = True):
    """The (header, rows) rank 0 broadcasts for a batch: [go, seed] and the
    conditioning rows (zeros for a stop)."""
    header = torch.tensor([int(go), seed], dtype=torch.int64)
    rows = torch.zeros((batch_size, len(serving.FEATURES)), dtype=torch.float32)
    if cond is not None:
        rows[: len(cond)] = torch.as_tensor(np.asarray(cond, np.float32))
    return header, rows


def leading(run, batch_size: int):
    """Rank 0's ``run(seed, cond)`` under a spatial mesh: the batch is broadcast
    to the followers first, so that every rank samples it."""
    def run_all(seed: int, cond):
        for t in _batch_message(batch_size, seed, cond):
            broadcast_(t)
        return run(seed, cond)

    return run_all


def follow(bundle, batch_size: int) -> int:
    """A follower rank of a spatial server: sample each batch rank 0 broadcasts,
    until it broadcasts a stop; returns the batches run."""
    run = bundle.sampler(batch_size)
    batches = 0
    while True:
        header, rows = (broadcast_(t) for t in _batch_message(batch_size, go=False))
        if not header[0]:
            return batches
        run(int(header[1]), rows.numpy())
        batches += 1


def stop_followers(batch_size: int) -> None:
    """Rank 0's stop to the followers (after its batcher has shut down)."""
    for t in _batch_message(batch_size, go=False):
        broadcast_(t)


def build_server(args, bundle=None):
    """(server, batcher) after the warm-up, ready for ``serve_forever``; under a
    spatial mesh rank 0's, whose batches reach the followers."""
    bundle = build_bundle(args) if bundle is None else bundle
    if args.workdir is None and (args.unet_weights is None or
                                 bundle.autoencoder is not None and args.ae_weights is None):
        logger.warning("no weights file and no workdir for a model: serving seeded random "
                       "weights")
    stats = (common.dataset_feature_stats(bundle.config) if args.stats_from_dataset
             else SUMMARY_STATISTICS)

    def normalize(cond_raw: np.ndarray) -> np.ndarray:
        return (cond_raw - stats[:, 0]) / stats[:, 1]

    run = bundle.sampler(args.batch_size)
    if bundle.mesh is not None:
        run = leading(run, args.batch_size)
    batcher = serving.Microbatcher(run, args.batch_size, max_delay_ms=args.max_delay_ms)
    # warm up BEFORE binding the port so /healthz readiness is truthful
    print(f"warming up {args.config} sampler (batch {args.batch_size}, "
          f"{args.num_steps} steps, {args.solver})...", flush=True)
    batcher.generate(np.zeros((1, len(serving.FEATURES)), np.float32), seed=0)

    device = bundle.device
    info = {
        "config": args.config, "solver": args.solver, "num_steps": args.num_steps,
        "batch_size": args.batch_size, "dtype": args.dtype,
        "t": bundle.t, "channels": bundle.sig_shape[-1],
        "features": list(serving.FEATURES),
        "devices": [torch.cuda.get_device_name(device) if device.type == "cuda"
                    else str(device)],
        "spatial": args.spatial, "int8": bool(args.int8),
    }
    return serving.make_server(batcher, normalize, info, host=args.host, port=args.port), batcher


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    common.run_ranks(serve, args, args.spatial)


def serve(args):
    """``main``'s server on this rank: rank 0 serves, the others follow it."""
    bundle = build_bundle(args)
    if rank() != 0:
        follow(bundle, args.batch_size)
        return
    server, batcher = build_server(args, bundle)
    print(f"serving on http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        batcher.shutdown()
        if bundle.mesh is not None:
            stop_followers(args.batch_size)


if __name__ == "__main__":
    main()
