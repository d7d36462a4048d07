"""Weight bridge: flax parameter trees -> the port's ``state_dict``s.

The port names its modules after the flax scopes, so a flax path maps to a
PyTorch key one to one.  This module owns every layout change:

  flax                                   port
  -------------------------------------  ---------------------------------
  <conv>/kernel (K..., I, O)             <conv>.weight (O, I, K...)
  <dense>/kernel (I, O)                  <dense>.weight (O, I)
  <x>/bias                               <x>.bias
  <norm>/GroupNorm_0/{scale,bias}        <norm>.{weight,bias}
  <fourier>/W                            <fourier>.W

``load_flax_train_state`` carries a whole JAX train state (parameters, EMA,
the optax Adam or AdamW moments and the non-finite guard's count) over into
the port's ``TrainState``.

It reads committed ``weights/*.msgpack`` artifacts (flax's msgpack layout,
arrays as extension type 1) with the ``msgpack`` package, without flax:

    python -m tqdne_tpu_torch.utils.convert weights/Autoencoder-...-ema.msgpack ae.pt
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

_NDARRAY_EXT = 1  # flax.serialization._MsgpackExtType.ndarray


def _array_from_ext(data: bytes) -> torch.Tensor:
    import msgpack

    shape, dtype, buf = msgpack.unpackb(data, raw=False)
    if dtype == "bfloat16":  # not a numpy dtype: reinterpret the raw 16-bit words
        t = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16).float()
    else:
        t = torch.from_numpy(np.frombuffer(buf, dtype=np.dtype(dtype)).copy())
    return t.reshape(shape)


def read_msgpack(path) -> dict:
    """A flax ``serialization.to_bytes`` file -> nested dict of tensors."""
    import msgpack

    def ext_hook(code, data):
        if code != _NDARRAY_EXT:
            raise ValueError(f"{path}: unsupported msgpack extension type {code}")
        return _array_from_ext(data)

    return msgpack.unpackb(Path(path).read_bytes(), ext_hook=ext_hook, raw=False,
                           strict_map_key=False)


def _flatten(tree: dict, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def flax_to_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """A flax variables or params tree (numpy arrays or tensors) -> the
    ``state_dict`` of the matching port module, in float32."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    sd = {}
    for path, value in _flatten(tree):
        t = value.float() if isinstance(value, torch.Tensor) else \
            torch.from_numpy(np.array(value, dtype=np.float32))
        *scope, leaf = path
        if scope and scope[-1] == "GroupNorm_0":
            scope = scope[:-1]
            leaf = {"scale": "weight", "bias": "bias"}[leaf]
        elif leaf == "kernel":
            leaf = "weight"
            # (K..., I, O) -> (O, I, K...); a Dense (I, O) -> (O, I) is the same move
            t = t.permute(t.ndim - 1, t.ndim - 2, *range(t.ndim - 2))
        elif leaf not in ("bias", "W"):
            raise ValueError(f"unexpected flax parameter {'/'.join(path)}")
        sd[".".join([*scope, leaf])] = t.contiguous()
    return sd


def optax_state_fields(opt_state) -> tuple[dict, dict, int, int]:
    """(mu, nu, count, notfinite_count) of an optax state: ``adam``'s or
    ``adamw``'s chain (``scale_by_adam``'s moments and update count), bare or
    inside ``apply_if_finite`` (its count of consecutive non-finite steps;
    0 without the guard).  Read by field name, without optax."""
    notfinite = int(getattr(opt_state, "notfinite_count", 0))
    todo = [getattr(opt_state, "inner_state", opt_state)]
    while todo:
        node = todo.pop(0)
        if hasattr(node, "mu") and hasattr(node, "nu"):
            return node.mu, node.nu, int(node.count), notfinite
        if isinstance(node, (tuple, list)):
            todo.extend(node)
    raise ValueError("no scale_by_adam state (mu, nu, count) in the optax state")


def load_flax_train_state(state, params: dict, ema_params: dict, mu: dict, nu: dict,
                          count: int, notfinite_count: int = 0, step: int | None = None) -> None:
    """Carry a JAX ``TrainState`` with an optax Adam or AdamW state over into
    the port's ``train.state.TrainState`` in place: ``params`` and
    ``ema_params`` into the live and EMA modules, the moments ``mu``/``nu``
    (trees shaped like the params, numpy arrays) and the update ``count``
    into the optimizer, and ``apply_if_finite``'s ``notfinite_count`` into
    the guard (``optax_state_fields`` reads all four off an optax state).
    ``state.step`` becomes the JAX ``step``, by default ``count`` (a run
    that never skipped an update).  The frozen Fourier ``W`` has no optimizer state in
    the port (its optax moments stay zero, as its gradient is stopped)."""
    state.model.load_state_dict(flax_to_state_dict(params))
    state.ema.load_state_dict(flax_to_state_dict(ema_params))
    moments = flax_to_state_dict(mu), flax_to_state_dict(nu)
    group = state.optimizer.param_groups[0]
    for name, p in state.model.named_parameters():
        if p.requires_grad:
            # fused and capturable optimizers keep the count beside the parameter
            on_param = group.get("fused") or group.get("capturable")
            state.optimizer.state[p] = {
                "step": torch.tensor(float(count), device=p.device if on_param else None),
                "exp_avg": moments[0][name].to(p.device, p.dtype),
                "exp_avg_sq": moments[1][name].to(p.device, p.dtype),
            }
    state.step = int(count if step is None else step)
    state.notfinite_count.fill_(notfinite_count)


def read_manifest(path) -> dict:
    """The ``hparams`` of a ``weights/*.manifest.json`` (for the classifier:
    ``encoder``, a module config, and ``num_classes``), with the JSON lists of
    a module config back as tuples, so a module is built at its artifact's
    own widths."""
    hparams = json.loads(Path(path).read_text())["hparams"]
    return {key: {k: tuple(v) if isinstance(v, list) else v for k, v in value.items()}
            if isinstance(value, dict) else value for key, value in hparams.items()}


def convert_file(src, dst) -> dict[str, torch.Tensor]:
    """Convert a flax msgpack artifact to a ``.pt`` state dict; returns it."""
    sd = flax_to_state_dict(read_msgpack(src))
    torch.save(sd, dst)
    return sd


def main(argv=None):
    parser = argparse.ArgumentParser(description="Convert a flax .msgpack weight artifact "
                                                 "to a PyTorch state dict (.pt).")
    parser.add_argument("src", help="flax serialization.to_bytes file (.msgpack)")
    parser.add_argument("dst", help="output .pt path")
    args = parser.parse_args(argv)
    sd = convert_file(args.src, args.dst)
    n = sum(t.numel() for t in sd.values())
    print(f"wrote {len(sd)} tensors ({n / 1e6:.1f}M params) to {args.dst}")


if __name__ == "__main__":
    main()
