"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``tqdne_tpu_torch``.  The run builds
the cell's system with weights drawn from ``--seed`` on the card, warms up
its shapes, measures for ``--seconds`` (``--trace 0``: the end-to-end
metrics) or traces a few whole batches or steps (``--trace 1``: the
per-layer metrics), then checks what the timed path produced against the
plain reference and prints one JSON line as the last line of its output.
It exits non-zero without a result when there is no CUDA card, or fewer
than the cell asks for, and when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

ROOT = Path.cwd()
FORBIDDEN = ("jax", "jaxlib", "flax", "tqdne_tpu")


def _setup_environment():
    """Caches inside the checkout, at fixed paths; nothing loads JAX."""
    cache = ROOT / "build" / "portbench-cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for path in (str(ROOT), str(Path(__file__).resolve().parents[1])):
        if path not in sys.path:
            sys.path.insert(0, path)


def loaded_forbidden() -> list[str]:
    """Modules of JAX, flax or the JAX package in this process, compared by
    whole top-level names."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def run_cell(cell, ctx) -> dict:
    """Drive ``cell`` on ``ctx`` and return the result line's object (without
    a card check: the caller makes it)."""
    import torch

    from portbench.harness import checks, registry

    result = registry.kind(cell.traffic["kind"], cell.bench_dir).run(cell, ctx)
    correct, compared = checks.verdict(result.readings, cell.limits)
    run = {"result": result, "ctx": ctx, "cell": cell}
    metrics = {}
    for m in (cell.per_layer if ctx.trace else cell.end_to_end):
        value = registry.reader(m["name"], cell.bench_dir)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
              else "cpu",
              "count": cell.chips, "memory_peak_bytes": ctx.memory_peak_bytes}
    out = {"correct": bool(correct and result.failed == 0),
           "attempted": result.units * result.unit_size, "failed": result.failed,
           "metrics": metrics, "device": device}
    if ctx.trace:
        red = result.layer["trace"]
        device.update(busy_s=red["busy_s"], window_s=result.window_s)
        out["breakdown"] = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
    out["checks"] = compared
    return out


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return done.stdout.strip().splitlines()[0] if done.returncode == 0 and done.stdout else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _setup_environment()

    import torch

    from portbench.harness import registry
    from portbench.harness.context import Ctx

    cell = registry.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    if args.trace:
        print(f"card: {power_limit()}", file=sys.stderr)
    ctx = Ctx(device=torch.device("cuda", 0), seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace))
    out = run_cell(cell, ctx)
    found = loaded_forbidden()
    if found:
        print(f"JAX or the JAX package was loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(_plain(out)))
    return 0


def _plain(obj):
    """The result with every non-finite number written as a string, so the
    line stays strict JSON."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    return obj


if __name__ == "__main__":
    sys.exit(main())
