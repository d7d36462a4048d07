"""The per-layer metrics that read the program's own ``tq::`` spans: a traced
CPU run of each kind reports every one its cell lists, the reduction holds
its sums together, puts each kernel under the spans around its launch and
names the idle gaps, and a program without the spans reads None."""

import math

import pytest
import torch

from portbench.harness import program_spans
from portbench.harness.context import Ctx
from portbench.run import run_cell
from portbench.tests.conftest import GEN, TRAIN, tiny_cell

GEN_LIMITS = {"signal_err": 0.05, "wave_err": 1e-4}
TRAIN_LIMITS = {"loss_gap": 5e-3, "grad_gap": 0.05, "change_gap": 0.05, "ema_gap": 0.05}
NEW = {"gen.denoise_ms", "gen.solver_ms", "gen.conv_ms", "gen.norm_layout_ms", "gen.host_ms",
       "gen.kernels", "train.loss_ms", "train.backward_ms", "train.update_ms"}


def traced(name, over, limits):
    cell = tiny_cell(name, limits=limits, **over)
    ctx = Ctx(device=torch.device("cpu"), seed=2**33 + 7, seconds=0.1, trace=True)
    run = {}
    original = program_spans.reading

    def keep(r):
        run.update(r)
        return original(r)

    program_spans.reading = keep
    try:
        out = run_cell(cell, ctx)
    finally:
        program_spans.reading = original
    return cell, out, run.get("program_spans")


@pytest.mark.parametrize("which", ["latent", "1d", "train"])
def test_traced_cpu_run_reports_every_new_metric(which):
    name, over = TRAIN if which == "train" else GEN[which]
    cell, out, spans = traced(name, over, TRAIN_LIMITS if which == "train" else GEN_LIMITS)
    listed = {m["name"] for m in cell.per_layer} & NEW
    assert listed and listed <= set(out["metrics"]), (listed, out["metrics"])
    assert all(out["metrics"][m]["value"] >= 0 for m in listed)
    assert out["correct"], out["checks"]
    if which == "train":
        # the step's parts, and what the benchmark's step adds: the loader's gather
        parts = sum(spans.ms(f"tq::{p}") for p in ("loss", "backward", "update"))
        rest = spans.ms("pb.step", ("tq::loss", "tq::backward", "tq::update"))
        assert math.isclose(parts + rest, spans.ms("pb.step"), rel_tol=1e-9)
        assert rest < 0.02 * parts
        return
    # a batch's sampler is its evaluations, its decode and the solver's own arithmetic
    m = {k: v["value"] for k, v in out["metrics"].items()}
    evals = spans.count["tq::denoise"] / spans.units
    assert evals == (2 * over["num_steps"] - 1)
    decode = spans.per_unit("tq::decode") or 0.0
    assert math.isclose(m["gen.denoise_ms"] * evals + m["gen.solver_ms"] + decode,
                        spans.per_unit("tq::sample"), rel_tol=1e-9)
    for tq, pb in (("sample", "sample"), ("invert", "invert"), ("norm", "norm"),
                   ("attention", "attn")):
        assert math.isclose(spans.per_unit(f"tq::{tq}"), spans.per_unit(f"pb.{pb}"),
                            rel_tol=0.05), tq


def test_a_program_without_the_spans_reads_none(monkeypatch):
    """The parent of the change that added the spans: no segment, no number."""
    monkeypatch.setattr(program_spans.importlib.util, "find_spec", lambda name: None)
    ctx = Ctx(device=torch.device("cpu"), seed=1, seconds=0.1, trace=True)
    run = {"cell": tiny_cell(*GEN["1d"][:1], **GEN["1d"][1]), "ctx": ctx}
    assert program_spans.reading(run) is None
    from portbench.harness import registry

    for name in sorted(NEW):
        assert registry.reader(name)(run) is None, name


def _ev(cat, name, ts, dur, tid=1, corr=None):
    args = {} if corr is None else {"correlation": corr}
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def test_reduction_on_a_card_trace():
    """Kernels fall under the spans that hold their launch, on any thread; the
    host time of ``tq::generate`` leaves out runtime calls; gaps are named."""
    events = [
        _ev("user_annotation", "tq::generate", 0, 100),
        _ev("user_annotation", "tq::sample", 1, 60),
        _ev("user_annotation", "tq::denoise", 2, 20),
        _ev("user_annotation", "tq::norm", 3, 10),
        _ev("user_annotation", "tq::group_norm_silu", 5, 4),
        _ev("cpu_op", "aten::copy_", 3.5, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 4, 0.5, corr=1),   # norm's layout copy
        _ev("cuda_runtime", "cudaLaunchKernel", 6, 0.5, corr=2),   # the GroupNorm
        _ev("cuda_runtime", "cudaLaunchKernel", 30, 10, corr=3),   # solver arithmetic, a wait
        _ev("user_annotation", "tq::backward", 200, 50, tid=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 210, 1, tid=2, corr=4),  # autograd's thread
        _ev("cuda_runtime", "cudaLaunchKernel", 300, 1, corr=5),   # outside every span
        _ev("kernel", "copy", 10, 5, corr=1),
        _ev("kernel", "gn", 15, 7, corr=2),
        _ev("kernel", "axpy", 40, 3, corr=3),
        _ev("kernel", "bwd", 215, 11, corr=4),
        _ev("gpu_memcpy", "memcpy", 400, 2, corr=5),
    ]
    s = program_spans.reduce(events, units=1)
    assert s.count["tq::denoise"] == 1 and s.ms("tq::norm") == pytest.approx(0.012)
    assert s.ms("tq::norm", ("tq::group_norm_silu",)) == pytest.approx(0.005)
    assert s.ms("tq::sample", ("tq::denoise",)) == pytest.approx(0.003)
    assert s.top_ops("tq::norm", ("tq::group_norm_silu",)) == [["copy", pytest.approx(0.005)]]
    assert s.ms("tq::backward") == pytest.approx(0.011)
    assert s.ms("tq::decode") is None
    assert s.generate_ops == 3
    assert s.generate_host_us == pytest.approx(100 - 0.5 - 0.5 - 10)
    names = dict(s.idle_gaps)
    assert len(names) == 3 and all(len(n) <= 64 for n in names)
    assert names["host:unknown-in-no_tq_span"] == pytest.approx(174e-6)  # 226 to 400
    assert "host:unknown-in-tq::backward" in names  # 43 to 215: the launch at 210
    assert "host:unknown-in-tq::sample" in names  # 22 to 40: the launch at 30
