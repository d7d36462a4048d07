"""Whole runs of each kind at widths a CPU holds: the program's plain paths
against the reference (bf16 as configured, and float32 where the two have to
agree to rounding), the planted faults that ``correct`` has to catch, and the
lower-precision controls that it has to fail."""

import math

import pytest
import torch

from portbench.harness.context import Ctx
from portbench.run import run_cell
from portbench.tests.conftest import GEN, TRAIN, tiny_cell

GEN_LIMITS = {"signal_err": 0.05, "wave_err": 1e-4}
TRAIN_LIMITS = {"loss_gap": 5e-3, "grad_gap": 0.05, "change_gap": 0.05, "ema_gap": 0.05}


def run(cell, seed=2**31 + 11, **ctx_kw):
    ctx = Ctx(device=torch.device("cpu"), seed=seed, seconds=0.2, trace=False, **ctx_kw)
    return run_cell(cell, ctx)


@pytest.mark.parametrize("which", ["latent", "1d"])
def test_generation_matches_reference_in_float32(which):
    name, over = GEN[which]
    out = run(tiny_cell(name, dtype="float32", limits=GEN_LIMITS, **over))
    assert out["checks"]["signal_err"]["value"] < 1e-4
    assert out["checks"]["wave_err"]["value"] < 1e-5
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= over["batch"]


@pytest.mark.parametrize("which", ["latent", "1d"])
def test_generation_bf16_is_correct(which):
    name, over = GEN[which]
    out = run(tiny_cell(name, limits=GEN_LIMITS, **over))
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"wf_per_s", "setup_s"}
    assert out["metrics"]["wf_per_s"]["value"] > 0


def test_train_step_matches_reference_in_float32():
    name, over = TRAIN
    out = run(tiny_cell(name, dtype="float32", limits=TRAIN_LIMITS, **over))
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert checks["loss_gap"] < 1e-5 and checks["grad_gap"] < 1e-4, checks
    # the EMA moves by a thousandth of the parameters' change, a few ulps of each parameter
    assert checks["change_gap"] < 1e-3 and checks["ema_gap"] < 1e-2, checks


def test_train_bf16_is_correct_and_reports():
    name, over = TRAIN
    out = run(tiny_cell(name, limits=TRAIN_LIMITS, **over))
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert out["attempted"] % over["batch"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("which", ["latent", "1d"])
def test_answer_altered_is_caught(which):
    name, over = GEN[which]
    out = run(tiny_cell(name, limits=GEN_LIMITS, **over), fault="answer_altered")
    assert not out["correct"]
    assert out["checks"]["wave_err"]["value"] > GEN_LIMITS["wave_err"]


def test_half_batch_is_caught():
    name, over = TRAIN
    out = run(tiny_cell(name, limits=TRAIN_LIMITS, **over), fault="half_batch")
    assert not out["correct"]


def test_unchanged_state_is_caught(monkeypatch):
    """A step that computes its loss and leaves the state as it was."""
    import tqdne_tpu_torch.train.steps as steps

    def no_update(state, ema_decay=0.999):
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1

    monkeypatch.setattr(steps, "apply_updates", no_update)
    name, over = TRAIN
    out = run(tiny_cell(name, limits=TRAIN_LIMITS, **over))
    assert not out["correct"]
    assert math.isclose(out["checks"]["change_gap"]["value"], 1.0)


@pytest.mark.parametrize("which", ["latent", "1d"])
def test_int8_control_reads_higher(which):
    """The program's own int8 path, one precision below the configuration's
    bf16, reads a wider sampled-signal gap than the bf16 path on the same seed."""
    name, over = GEN[which]
    cell = tiny_cell(name, limits=GEN_LIMITS, **over)
    sound = run(cell)["checks"]["signal_err"]["value"]
    control = run(cell, control="int8")["checks"]["signal_err"]["value"]
    assert control > 3 * sound


@pytest.mark.parametrize("which", ["latent", "1d"])
def test_bf16_inversion_control_fails(which):
    name, over = GEN[which]
    out = run(tiny_cell(name, limits=GEN_LIMITS, **over), control="lowp_inverse")
    assert out["checks"]["wave_err"]["value"] > GEN_LIMITS["wave_err"]
    assert not out["correct"]


def test_fp8_reference_control_reads_higher():
    name, over = TRAIN
    cell = tiny_cell(name, limits=TRAIN_LIMITS, **over)
    sound = run(cell)["checks"]["grad_gap"]["value"]
    control = run(cell, control="lowp_reference")["checks"]["grad_gap"]["value"]
    assert control > 3 * sound
