"""``gen.conv_bias_ms``: a traced CPU run of each generation cell that lists it reports it,
inside ``gen.conv_ms``, and a program whose convolutions open no ``tq::conv_bias`` span (one
that adds the bias inside cuDNN) reads None there without failing the run."""

import contextlib

import pytest
import torch

from portbench.harness.context import Ctx
from portbench.run import run_cell
from portbench.tests.conftest import GEN, tiny_cell

LIMITS = {"signal_err": 0.05, "wave_err": 1e-4}


def traced(which):
    name, over = GEN[which]
    cell = tiny_cell(name, limits=LIMITS, **over)
    ctx = Ctx(device=torch.device("cpu"), seed=2**33 + 21, seconds=0.1, trace=True)
    return cell, run_cell(cell, ctx)


@pytest.mark.parametrize("which", ["latent", "1d"])
def test_traced_cpu_run_reports_the_epilogue(which):
    cell, out = traced(which)
    assert "gen.conv_bias_ms" in {m["name"] for m in cell.per_layer}
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert 0 <= m["gen.conv_bias_ms"] <= m["gen.conv_ms"], m
    assert out["correct"], out["checks"]


def test_a_program_without_the_span_reads_none(monkeypatch):
    from tqdne_tpu_torch.nn import layers

    span = layers.span

    def no_epilogue_span(name):
        return contextlib.nullcontext() if name == "conv_bias" else span(name)

    monkeypatch.setattr(layers, "span", no_epilogue_span)
    _, out = traced("1d")
    assert "gen.conv_bias_ms" not in out["metrics"] and "gen.conv_ms" in out["metrics"]
    assert out["correct"], out["checks"]
