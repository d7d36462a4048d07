"""Read the numbers that decide ``correct`` on many seeds in one process: the
program's sound runs (the lower readings), its lower-precision controls and
planted faults (the upper readings), at the cell's own size.  The limits in
``limits/<cell>.json`` are set from these readings; the benchmark's own runs
never run this.

    python3 portbench/control.py --workload <cell> --mode <mode> --seeds 1,2,3

Modes: ``program``; ``int8`` (the program's int8 convolutions, one precision
below its bf16); ``lowp_inverse`` (the reference's inversion in bf16 in the
program's place); ``lowp_reference`` (the reference's training steps in fp8
in the program's place); ``half_batch`` (each step trains on half its batch).
Each seed runs one batch (or the checked steps and one more) and compares as
many rows as a run does.  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.run import ROOT, _setup_environment, run_cell  # noqa: E402

MODES = {"program": {}, "int8": {"control": "int8"},
         "lowp_inverse": {"control": "lowp_inverse"},
         "lowp_reference": {"control": "lowp_reference"}, "half_batch": {"fault": "half_batch"}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--mode", choices=sorted(MODES), default="program")
    parser.add_argument("--seeds", required=True, help="comma-separated")
    args = parser.parse_args(argv)
    _setup_environment()

    import torch

    from portbench.harness import registry
    from portbench.harness.context import Ctx

    cell = registry.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    if cell.traffic["kind"] == "generate":  # one batch holds the rows a run compares
        cell.traffic["check_rows_per_batch"] = cell.traffic["check_rows"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = Ctx(device=torch.device("cuda", 0), seed=seed, seconds=0.0, trace=False,
                  **MODES[args.mode])
        out = run_cell(cell, ctx)
        readings = {k: v["value"] for k, v in out["checks"].items()}
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "readings": readings, "failed": out["failed"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
