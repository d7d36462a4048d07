"""The ``latent_dit.generate`` cell's kind on the CPU at small widths: the DiT
against the reference (float32 to rounding, bf16 within the limits), the
controls that ``correct`` has to fail, the counters the kind checks, the
traced run's new metrics, and ``harness/dit_flops.py`` against
``torch.utils.flop_counter`` over the reference."""

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import dit_flops, inputs, registry
from portbench.harness.context import Ctx
from portbench.reference import dit as ref_dit
from portbench.run import run_cell
from portbench.tests.conftest import ROOT

LIMITS = {"signal_err": 0.05, "wave_err": 1e-4}
SMALL = dict(hidden_size=96, depth=2, num_heads=4)  # heads of 24, not a power of two
OVER = dict(batch=2, num_steps=3, griffin_lim_iters=4, check_rows_per_batch=1, check_rows=2,
            reference_block=2, trace_batches=1)


def small_cell(dtype=None, limits=None):
    cell = registry.load_cell(ROOT, "latent_dit.generate")
    cfg = copy.deepcopy(cell.config)
    cfg.pop("dit_parameters")
    cfg["tiny"] = True
    cfg["dit"] |= SMALL
    for part in ("encoder", "decoder"):
        cfg["autoencoder"][part]["model_channels"] = 32
    if dtype is not None:
        cfg["dtype"] = dtype
    cell.config, cell.traffic = cfg, cell.traffic | OVER
    cell.limits = dict(limits or LIMITS)
    return cell


def run(cell, seed=2**31 + 13, seconds=0.2, trace=False, **kw):
    ctx = Ctx(device=torch.device("cpu"), seed=seed, seconds=seconds, trace=trace, **kw)
    return run_cell(cell, ctx)


def test_tiny_widths_are_the_programs():
    """The cell's small widths are the program's ``--tiny`` DiT, as the
    benchmark's build asks for."""
    from tqdne_tpu_torch.cli.common import TINY_DIT

    assert SMALL == TINY_DIT


def test_float32_matches_reference():
    out = run(small_cell("float32"))
    assert out["checks"]["signal_err"]["value"] < 1e-4, out["checks"]
    assert out["checks"]["wave_err"]["value"] < 1e-5, out["checks"]
    assert out["correct"] and out["failed"] == 0


def test_bf16_is_correct_and_reports():
    out = run(small_cell())
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"wf_per_s", "setup_s"}


@pytest.mark.parametrize("control,reading", [("lowp_reference", "signal_err"),
                                             ("lowp_inverse", "wave_err")])
def test_controls_read_higher(control, reading):
    cell = small_cell()
    sound = run(cell, seconds=0)["checks"][reading]["value"]
    low = run(cell, seconds=0, control=control)["checks"][reading]["value"]
    assert low > 3 * sound, (sound, low)


def test_counters_are_checked(monkeypatch):
    """A sampler that evaluates the network once more than the traffic asks
    breaks ``DiT.forwards``' count: the run exits."""
    from tqdne_tpu_torch.models.dit import DiT

    forward = DiT.forward

    def twice(self, *args):
        forward(self, *args)
        return forward(self, *args)

    monkeypatch.setattr(DiT, "forward", twice)
    with pytest.raises(SystemExit, match="DiT.forwards"):
        run(small_cell())


def test_traced_run_records_its_evaluations():
    """The traced window (its metrics need a card's kernels) counts the
    evaluations it ran and the modulation's bytes they move."""
    cell = small_cell()
    ctx = Ctx(device=torch.device("cpu"), seed=7, seconds=0.2, trace=True)
    res = registry.kind("generate_dit").run(cell, ctx)
    assert res.layer["evals"] == 5 and res.units == 1
    assert res.layer["modulate_bytes"] == 5 * dit_flops.modulate_bytes(cell.config["dit"], 2, 2)
    assert res.layer["attn_flops"] > 0 and res.readings["signal_err"] < LIMITS["signal_err"]


def test_flops_match_the_flop_counter():
    cfg = small_cell().config["dit"] | {"input_size": 8}
    P = inputs.make_weights(ref_dit.shapes(cfg), torch.Generator().manual_seed(0), "cpu")
    x, t, c = torch.randn(3, 8, 8, 8), torch.randn(3), torch.randn(3, 5)
    with FlopCounterMode(display=False) as counter:
        ref_dit.dit(P, cfg, x, t, c)
    assert counter.get_total_flops() == sum(dit_flops.forward(cfg, 3).values())


def test_published_flops_and_modulation_bytes():
    """237.2 GFLOP a sample and evaluation; 21.3 GB of modulation at 128 in bf16."""
    cfg = registry.load_cell(ROOT, "latent_dit.generate").config["dit"]
    assert abs(sum(dit_flops.forward(cfg, 1).values()) / 1e9 - 237.2) < 0.1
    assert abs(dit_flops.modulate_bytes(cfg, 128, 2) / 1e9 - 21.3) < 0.1
