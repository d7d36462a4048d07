"""The ``1d_edm.train.dp4`` cell's kind on the CPU: four gloo ranks at a small
batch against the reference over the global batch (float32 to rounding,
the replicas equal bit for bit), the planted faults ``correct`` has to
catch, and a rank that dies ending the run in seconds."""

import time

import pytest
import torch

from portbench.harness.context import Ctx
from portbench.run import run_cell
from portbench.tests.conftest import tiny_cell

LIMITS = {"loss_gap": 5e-3, "grad_gap": 0.05, "change_gap": 0.05, "ema_gap": 0.05,
          "rank_gap": 5e-324}
OVER = dict(batch=2, dataset_rows=32, checked_steps=2, reference_block=4, trace_steps=1)


def run(dtype=None, **ctx_kw):
    cell = tiny_cell("1d_edm.train.dp4", dtype=dtype, limits=LIMITS, **OVER)
    ctx = Ctx(device=torch.device("cpu"), seed=2**32 + 5, seconds=0.5, trace=False, **ctx_kw)
    return run_cell(cell, ctx)


def test_float32_matches_reference_over_the_global_batch():
    out = run("float32")
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert checks["rank_gap"] == 0.0, checks
    assert checks["loss_gap"] < 1e-5 and checks["grad_gap"] < 1e-4, checks
    assert checks["change_gap"] < 1e-3 and checks["ema_gap"] < 1e-2, checks
    assert out["correct"] and out["attempted"] % (4 * OVER["batch"]) == 0
    assert set(out["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert out["metrics"]["setup_s"]["value"] > 0


def test_half_batch_is_caught():
    out = run(fault="half_batch")
    assert not out["correct"]


def test_a_dying_rank_ends_the_run():
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="rank 3 exited"):
        run(fault="rank_dies")
    assert time.perf_counter() - t0 < 60
