"""Export a port run's EMA weights as a standalone release artifact: the port
of ``tqdne_tpu/cli/export_weights.py``.

A run under ``<workdir>/outputs/<name>/checkpoints`` is written as one flax
msgpack file in the layout both packages read (``utils.convert``: nested
flax paths, arrays as extension type 1; the bytes flax's
``serialization.to_bytes`` writes for the same arrays) and a manifest with
the file's SHA-256, the step, the dtype, the parameter count, the run's
``hparams.json`` and its progress.  ``--digest-out`` also records the digest
in a registry file, so evidence can be tied to the exact parameters while
the weights themselves travel out of band:

    python -m tqdne_tpu_torch.cli.export_weights latent_edm --workdir W --out weights/ \\
        --digest-out docs/quality/WEIGHTS_DIGESTS.json

``load_exported`` reads an artifact of either package, refusing one whose
bytes do not match its manifest's digest (``build_inference(exported_weights=)``
and the generate CLI's ``--weights`` sample from it).  ``msgpack`` is
imported where an artifact is read or written.
"""

from __future__ import annotations

import argparse
import hashlib
import json
from datetime import datetime, timezone
from pathlib import Path

from tqdne_tpu_torch.cli.common import RECIPES, parse_dtype
from tqdne_tpu_torch.train.checkpoint import Checkpointer
from tqdne_tpu_torch.utils.convert import pack_msgpack, state_dict_to_flax, unpack_msgpack


def export_weights(recipe_key: str, workdir, out_dir, dtype: str = "bf16",
                   digest_out=None, run_name: str | None = None) -> Path:
    """Write ``<out_dir>/<name>-ema.msgpack`` and its ``.manifest.json`` from
    the newest checkpoint of the run ``run_name`` (default: the recipe's);
    returns the weights path."""
    recipe = RECIPES[recipe_key]
    config = recipe.config_cls(workdir=workdir)
    name = run_name or recipe.name
    ckpt = Checkpointer(Path(config.outputdir) / name / "checkpoints")
    restored = ckpt.restore_latest_raw()
    if restored is None:
        raise SystemExit(f"no checkpoint under {ckpt.directory}")
    state, step = restored
    params = state_dict_to_flax({k: v.to(parse_dtype(dtype)) for k, v in state["ema"].items()})

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    wpath = out / f"{name}-ema.msgpack"
    data = pack_msgpack(params)
    wpath.write_bytes(data)
    manifest = {
        "run_name": name,
        "recipe": recipe_key,
        "checkpoint_step": int(step),
        "dtype": dtype,
        "param_count": int(sum(v.numel() for v in state["ema"].values())),
        "sha256": hashlib.sha256(data).hexdigest(),
        "file": wpath.name,
        "exported_at": datetime.now(timezone.utc).isoformat(timespec="seconds"),
    }
    hp = ckpt.restore_hyperparameters()
    if hp is not None:
        manifest["hparams"] = hp
    progress = ckpt.directory / "progress.json"
    if progress.exists():
        prog = json.loads(progress.read_text())
        # the live run's progress is this artifact's budget only where the steps agree
        if int(prog.get("step", -1)) == int(step):
            manifest["train_progress"] = prog
    mpath = out / f"{name}-ema.manifest.json"
    mpath.write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")

    if digest_out:
        dpath = Path(digest_out)
        digests = json.loads(dpath.read_text()) if dpath.exists() else {}
        digests[name] = {k: manifest[k] for k in
                         ("sha256", "checkpoint_step", "dtype", "param_count", "recipe", "file")}
        dpath.parent.mkdir(parents=True, exist_ok=True)
        dpath.write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
        print(f"digest recorded in {dpath}")

    print(f"exported {manifest['param_count'] / 1e6:.1f}M params (step {step}, {dtype}) "
          f"-> {wpath}")
    return wpath


def load_exported(weights_path) -> tuple[dict, dict | None]:
    """(the flax variables tree of tensors, the manifest or None) of an
    exported artifact; verifies the sibling manifest's digest where it
    exists (SystemExit on a mismatch)."""
    wpath = Path(weights_path)
    data = wpath.read_bytes()
    manifest = None
    mpath = wpath.parent / (wpath.stem + ".manifest.json")
    if mpath.exists():
        manifest = json.loads(mpath.read_text())
        digest = hashlib.sha256(data).hexdigest()
        if digest != manifest["sha256"]:
            raise SystemExit(
                f"{wpath}: sha256 mismatch vs manifest ({digest[:12]}... != "
                f"{manifest['sha256'][:12]}...) — artifact corrupted or swapped")
    return unpack_msgpack(data, str(wpath)), manifest


def main(argv=None):
    parser = argparse.ArgumentParser("tqdne_tpu_torch.cli.export_weights",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("recipe", choices=sorted(RECIPES))
    parser.add_argument("--workdir", default="qrun")
    parser.add_argument("--out", default="weights")
    parser.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    parser.add_argument("--digest-out", default=None,
                        help="also record {run: sha256, ...} in this digest registry "
                             "(docs/quality/WEIGHTS_DIGESTS.json)")
    parser.add_argument("--run-name", default=None)
    args = parser.parse_args(argv)
    export_weights(args.recipe, args.workdir, args.out, args.dtype, args.digest_out,
                   args.run_name)


if __name__ == "__main__":
    main()
