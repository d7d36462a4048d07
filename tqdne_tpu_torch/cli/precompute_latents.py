"""Cache the frozen autoencoder's latent moments: the port of
``tqdne_tpu/cli/precompute_latents.py``.

The encoder's moments (mean, log_std) are a deterministic function of the
waveform, so they are computed once and the latent EDM step samples
``mean + eps * exp(log_std)`` from them, with no encoder in the step.
``latent_moments`` is the work; the CLI writes its arrays to
``data/latents-<ae_name>.h5`` beside the dataset, rows in the dataset's
storage order, with the attributes ``ae_name``, ``dtype``,
``ae_fingerprint`` and ``n_rows_written``.  A sidecar that already matches
the weights is kept unless ``--force`` is given:

    python -m tqdne_tpu_torch.cli.precompute_latents --workdir W [--ae-weights ae.pt] \\
        [--tiny] [-b 64] [--dtype f32] [--device cuda]

Without ``--ae-weights`` the autoencoder is the port's own run
``outputs/<ae_name>`` in the same workdir.  Train from the sidecar with
``python -m tqdne_tpu_torch.cli.train latent_edm --cached-latents``.  The
files are HDF5 and need ``h5py``.
"""

from __future__ import annotations

import argparse
import hashlib
from pathlib import Path

import numpy as np
import torch

from tqdne_tpu_torch import configs
from tqdne_tpu_torch.cli import common
from tqdne_tpu_torch.ops.representation import device_representation_fn
from tqdne_tpu_torch.utils import resolve_device


def latents_path(config, ae_name: str) -> Path:
    return Path(config.datapath).parent / f"latents-{ae_name}.h5"


def ae_fingerprint(state_dict: dict) -> str:
    """SHA-256 over every tensor's name, shape and first and last 64 values
    (as float32), in name order: a sidecar must be recomputed whenever the
    weights change.  It is taken over the port's state dict, so a sidecar
    the JAX package wrote does not match it."""
    h = hashlib.sha256()
    for name in sorted(state_dict):
        arr = state_dict[name].detach().float().cpu().numpy().ravel()
        h.update(name.encode())
        h.update(str(tuple(state_dict[name].shape)).encode())
        h.update(arr[:64].tobytes())
        h.update(arr[-64:].tobytes())
    return h.hexdigest()


@torch.no_grad()
def latent_moments(ae, waveforms, representation, *, cut: int | None = None, batch: int = 64,
                   device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """(latent_mean, latent_log_std), float32 numpy arrays of shape
    (N, *latent, C), for the (N, 3, T) ``waveforms`` (an array or an HDF5
    dataset, read in blocks of ``batch`` rows) cut to ``cut`` samples: the
    representation on ``device``, then ``ae.moments``."""
    device = torch.device(device)
    to_signal = device_representation_fn(representation)
    means, log_stds = [], []
    for s in range(0, len(waveforms), batch):
        block = torch.from_numpy(np.ascontiguousarray(waveforms[s : s + batch][..., :cut],
                                                      dtype=np.float32))
        mean, log_std = ae.moments(to_signal(block.to(device).movedim(1, -1)))
        means.append(mean.float().cpu().numpy())
        log_stds.append(log_std.float().cpu().numpy())
    return np.concatenate(means), np.concatenate(log_stds)


def sidecar_fingerprint(path) -> str:
    """The ``ae_fingerprint`` attribute of a latents file ("" when absent)."""
    import h5py

    with h5py.File(path, "r", locking=False) as f:
        return str(f.attrs.get("ae_fingerprint", ""))


def run(args) -> Path:
    import h5py

    config = configs.LatentSpectrogramConfig(workdir=args.workdir)
    device = resolve_device(args.device)
    ae_name = args.ae_name or common.AE_NAME
    ae, _, _ = common.frozen_autoencoder(config, common.parse_dtype(args.dtype), tiny=args.tiny,
                                         weights=args.ae_weights, ae_name=ae_name)
    fingerprint = ae_fingerprint(ae.state_dict())
    ae.to(device).eval()
    if device.type == "cuda":
        ae.to(memory_format=torch.channels_last)

    out_path = latents_path(config, ae_name)
    if out_path.exists() and not args.force:
        # a re-run keeps a complete sidecar of these weights; a truncated or
        # unreadable one is rewritten
        try:
            with h5py.File(out_path, "r", locking=False) as f:
                complete = f["latent_mean"].shape[0] == f.attrs.get("n_rows_written", -1)
                if complete and str(f.attrs.get("ae_fingerprint", "")) == fingerprint:
                    print(f"latents up to date for these AE weights -> {out_path}")
                    return out_path
        except (OSError, KeyError):
            pass

    with h5py.File(config.datapath, "r", locking=False) as src, h5py.File(out_path, "w") as dst:
        mean, log_std = latent_moments(ae, src["waveforms"], config.make_representation(),
                                       cut=config.t, batch=args.batch, device=device)
        dst.create_dataset("latent_mean", data=mean)
        dst.create_dataset("latent_log_std", data=log_std)
        dst.attrs["ae_name"] = ae_name
        dst.attrs["dtype"] = args.dtype
        dst.attrs["ae_fingerprint"] = fingerprint
        dst.attrs["n_rows_written"] = len(mean)
    print(f"wrote {len(mean)} latent moment rows -> {out_path}")
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser("tqdne_tpu_torch.cli.precompute_latents",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--workdir", type=str, required=True)
    parser.add_argument("--ae-name", type=str, default=None,
                        help=f"autoencoder run name under outputs/ (default: {common.AE_NAME})")
    parser.add_argument("--ae-weights", type=str, default=None,
                        help="autoencoder state dict (.pt) in place of the run's checkpoint")
    parser.add_argument("-b", "--batch", type=int, default=64)
    # f32: the encode runs once, and bf16 moments would degrade an f32 training run
    parser.add_argument("--dtype", type=str, default="f32", choices=["f32", "bf16"])
    parser.add_argument("--tiny", action="store_true",
                        help="the 32-channel autoencoder of a --tiny run")
    parser.add_argument("--force", action="store_true",
                        help="recompute even when the sidecar matches the AE weights")
    parser.add_argument("--device", type=str, default="cuda")
    return run(parser.parse_args(argv))


if __name__ == "__main__":
    main()
