"""Alternated end-to-end A/B of two checkouts of the port on one NVIDIA GPU.

    python3 chip_ab.py A_DIR B_DIR [--pairs 6]

Runs one process per measurement, from each checkout in turn (A B B A A B
...), so that both commits share the card and the host within one call.
Each process builds its checkout's kernels and measures, with seeded random
weights, the bf16 flagship train step at batch 128 (samples/s over 5 windows
of 8 steps on a resident batch) and dpmpp_2m-10 + Griffin-Lim 32 sampling at
batch 32 (waveforms/s over 5 runs), through the checkout's own
``chip_smoke.training_setup`` and ``build_inference``.  Prints each run's
JSON line, the card's name and power limit, then each side's medians and
quartiles and how many of the adjacent A/B pairs B wins.  Exits non-zero
without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def measure() -> dict:
    """One checkout's numbers; run with that checkout as the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke
    from tqdne_tpu_torch.cli.common import build_inference
    from tqdne_tpu_torch.data.dataset import ArrayDataset, synthetic_arrays
    from tqdne_tpu_torch.data.pipeline import BatchLoader
    from tqdne_tpu_torch.ops import cuda_build

    cuda_build.build()
    dev = torch.device("cuda")
    config, state, (train_step, _), *_ = chip_smoke.training_setup(dev, torch.bfloat16)
    data = ArrayDataset(synthetic_arrays(256, t=config.t, seed=0), config.make_representation(),
                        cut=config.t, cond=True, split="full")
    batch = next(iter(BatchLoader(data, 128, device=dev, keys=("signal", "cond"), seed=0)))
    gen = torch.Generator(device=dev).manual_seed(0)

    def rate(fn, items, runs, reps=1):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(runs):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            out.append(items * reps / (time.perf_counter() - t0))
        return out

    train = rate(lambda: train_step(state, batch, generator=gen), 128, 5, reps=8)
    del state
    bundle = build_inference(dtype=torch.bfloat16, num_steps=10, solver="dpmpp_2m", gl_iters=32,
                             device=dev, init_seed=0)
    cond = torch.randn(32, 5, generator=gen, device=dev)
    sample = rate(lambda: bundle.generate(cond, generator=gen), 32, 5)
    return {"train_samples_per_s": train, "dpmpp_wf_per_s": sample}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("dirs", nargs="*", help="the two checkouts, A then B")
    parser.add_argument("--pairs", type=int, default=6)
    parser.add_argument("--one", action="store_true", help="measure the working directory")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    if args.one:
        print(json.dumps(measure()), flush=True)
        return
    if len(args.dirs) != 2:
        parser.error("give two checkouts")
    order = [("A", "B"), ("B", "A")]
    runs = []
    for i in range(args.pairs):
        for side in order[i % 2]:
            where = args.dirs[side == "B"]
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one"], cwd=where,
                                  capture_output=True, text=True, timeout=900)
            if proc.returncode:
                print(proc.stdout + proc.stderr[-4000:], file=sys.stderr)
                sys.exit(f"chip_ab: the run in {where} failed")
            numbers = json.loads(proc.stdout.strip().splitlines()[-1])
            runs.append((side, numbers))
            print(json.dumps({"run": len(runs), "side": side, "dir": where, **numbers}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    for key in ("train_samples_per_s", "dpmpp_wf_per_s"):
        medians = {s: [statistics.median(n[key]) for side, n in runs if side == s] for s in "AB"}
        wins = sum(b > a for a, b in zip(medians["A"], medians["B"]))  # the i-th A/B pair
        print(json.dumps({"metric": key, "B_wins_pairs": wins, "pairs": len(runs) // 2,
                          **{f"{s}_median": statistics.median(v) for s, v in medians.items()},
                          **{f"{s}_quartiles": statistics.quantiles(v, n=4)
                             for s, v in medians.items()},
                          **{f"{s}_runs": v for s, v in medians.items()}}))


if __name__ == "__main__":
    main()
