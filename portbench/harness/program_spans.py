"""The port's own spans (``tq::``, from ``tqdne_tpu_torch.utils.tracing``) in a
traced segment of the cell, for the per-layer metrics that read them.

The kinds' traced window reduces the benchmark's spans (``pb.``).  This module
traces the same loop once more, in the same process, after the run and its
check: the system built again from the seed and warmed up, then the traced
window's batches or steps under the profiler, with the benchmark's spans
installed as the kind installs them, so that the program's spans and the
benchmark's lie in one trace.  The first reader measures it; the reduction is
kept in the run for the others.  A program without ``utils.tracing`` has no
such spans: it gets no segment, and every reader returns None.

A kernel, copy or memset belongs to every span whose interval holds its
launch (on any thread: a backward's kernels launch from autograd's thread
while ``tq::backward`` waits).  On the CPU, which launches nothing, each
innermost operator stands for a kernel, launched at its start.  The segment's
ten longest idle gaps are printed on standard error, each named by the
innermost host operator and the innermost ``tq::`` span (or ``no_tq_span``)
around the launch that ended it.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import sys
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field

import torch

from portbench.harness import registry, trace

PREFIXES = ("tq::", "pb.")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# the spans whose largest operations the summary lists, each without the spans after it
TOP_OPS = (("tq::conv", ()), ("tq::norm", ("tq::group_norm_silu",)),
           ("tq::sample", ("tq::denoise", "tq::decode")), ("tq::loss", ("tq::conv", "tq::norm")),
           ("tq::backward", ("tq::group_norm_silu_backward",)))


@dataclass
class Spans:
    """One segment reduced: ``units`` batches or steps, the instances of each
    span, the device microseconds of each set of spans that held a launch,
    and, over every ``tq::generate``, the host microseconds outside CUDA
    runtime and driver calls and the device operations launched."""

    units: int
    count: dict = field(default_factory=dict)
    inside_us: dict = field(default_factory=dict)  # frozenset of span names -> device us
    op_us: dict = field(default_factory=dict)  # (frozenset of span names, op name) -> us
    generate_host_us: float = 0.0
    generate_ops: int = 0
    idle_gaps: list = field(default_factory=list)

    def ms(self, inside: str, outside=()) -> float | None:
        """Device ms of the operations launched inside ``inside`` and inside
        none of ``outside``; None when the trace has no ``inside``."""
        if inside not in self.count:
            return None
        return sum(us for names, us in self.inside_us.items()
                   if inside in names and not names.intersection(outside)) / 1e3

    def top_ops(self, inside: str, outside=(), n: int = 4) -> list:
        """The ``n`` operations with the most device ms a unit inside ``inside``
        and outside every span of ``outside``."""
        by_op = Counter()
        for (names, op), us in self.op_us.items():
            if inside in names and not names.intersection(outside):
                by_op[op] += us / 1e3 / self.units
        return [[trace._clean(op), ms] for op, ms in by_op.most_common(n)]

    def per_unit(self, inside: str, outside=()) -> float | None:
        ms = self.ms(inside, outside)
        return None if ms is None else ms / self.units


def reading(run) -> Spans | None:
    """The run's segment, measured by the first reader that asks."""
    if "program_spans" not in run:
        run["program_spans"] = measure(run["cell"], run["ctx"])
    return run["program_spans"]


def measure(cell, ctx) -> Spans | None:
    """One traced segment of ``cell`` reduced, its summary printed on standard
    error; None for a program without the spans."""
    if importlib.util.find_spec("tqdne_tpu_torch.utils.tracing") is None:
        return None
    t0 = time.perf_counter()
    ctx.free()  # the reference's cached blocks back to the card, as before the kind's window
    kind = registry.kind(cell.traffic["kind"], cell.bench_dir)
    segment = _generate if cell.traffic["kind"] == "generate" else _train
    events, units = segment(cell, ctx, kind)
    ctx.free()
    t1 = time.perf_counter()
    spans = reduce(events, units)
    summary = {"seconds": [t1 - t0, time.perf_counter() - t1],
               "per_unit_ms": {n: spans.per_unit(n) for n in sorted(spans.count)},
               "count": spans.count,
               "generate_host_ms": spans.generate_host_us / 1e3 / units,
               "generate_ops": spans.generate_ops / units, "idle_gaps": spans.idle_gaps,
               "top_ops_ms": {f"{n}-{'-'.join(out)}": spans.top_ops(n, out)
                              for n, out in TOP_OPS if n in spans.count}}
    print(f"program spans over {units} units: {json.dumps(summary)}", file=sys.stderr)
    return spans


def _generate(cell, ctx, kind):
    """The kind's traced window again: its batches, with the benchmark's spans."""
    from tqdne_tpu_torch.nn import attention as attention_module

    bundle = kind.build(cell, ctx, int8=ctx.control == "int8")
    sample = bundle.sample
    delivery, bad = [], torch.zeros((), dtype=torch.int64, device=ctx.device)

    def traced_sample(cond, **kw):
        with trace.span("pb.sample"):
            return sample(cond, **kw)

    def one_batch(b: int) -> None:
        nonlocal bad
        noise, cond, phase = kind.batch_inputs(cell, ctx, bundle.model_shape, b)
        wave = bundle.generate(cond, noise=noise, init_phase=phase)
        bad += (~torch.isfinite(wave).flatten(1).all(dim=1)).sum()
        if not delivery:
            delivery.append(kind.Delivery(ctx.device, wave.shape, wave.dtype,
                                          lambda b, host: None))
        delivery[0].send(b, wave)

    one_batch(-1)  # the warm-up: the allocator's cache, the host buffers
    delivery[0].drain()
    n = cell.traffic["trace_batches"]
    rec = trace.Recorder()
    kind.instrument(bundle, rec)
    bundle.sample = traced_sample
    ctx.synchronize()
    with trace.wrapped_attention(attention_module, rec), trace.profiler() as prof:
        for b in range(n, 2 * n):
            one_batch(b)
        delivery[0].drain()
        ctx.synchronize()
    del bundle, delivery
    return trace.trace_events(prof), n


def _train(cell, ctx, kind):
    """The kind's traced window again: the set-up's steps, then its traced steps
    inside ``pb.step`` with the ``Norm32`` spans."""
    from tqdne_tpu_torch.nn.layers import Norm32

    state, train_step, loader = kind.build(cell, ctx)
    gen = torch.Generator(device=ctx.device)
    feed = kind.batches(loader)
    bad = torch.zeros((), device=ctx.device)

    def step(n: int) -> None:
        nonlocal bad
        batch = next(feed)
        kind.seed_step(ctx, gen, n)
        loss = train_step(state, batch, generator=gen)["loss"]
        bad += (~torch.isfinite(loss)).float()

    first, n = cell.traffic["checked_steps"], cell.traffic["trace_steps"]
    for i in range(first):
        step(i)
    trace.wrap_norms(state.model, trace.Recorder(), Norm32)
    ctx.synchronize()
    with trace.profiler() as prof:
        for i in range(n):
            with trace.span("pb.step"):
                step(first + i)
        ctx.synchronize()
    del state, train_step, loader, feed
    return trace.trace_events(prof), n


def _innermost_leaves(ops) -> list:
    """The operators (start, end, thread, name) that hold no other on their
    thread, as (start, end, name)."""
    by_thread = defaultdict(list)
    for s, e, tid, name in ops:
        by_thread[tid].append((s, e, name))
    leaves = []
    for iv in by_thread.values():
        iv.sort(key=lambda x: (x[0], -x[1]))
        for i, (s, e, name) in enumerate(iv):
            if i + 1 == len(iv) or iv[i + 1][0] >= e:
                leaves.append((s, e, name))
    return leaves


def _covering(intervals, starts, at):
    """The instance of a span (intervals sorted by start, no two of one name
    nested) that holds time ``at``, or None."""
    i = bisect.bisect_right(starts, at) - 1
    return intervals[i] if i >= 0 and intervals[i][1] >= at else None


def _union_us(intervals) -> float:
    return sum(e - s for s, e in trace._union(intervals))


def reduce(events: list, units: int) -> Spans:
    """Trace events -> ``Spans`` over ``units`` batches or steps."""
    gpu, launches, cpu_ops, host = [], {}, [], []
    spans, runtime = defaultdict(list), defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev.get("ts", 0.0))
        e, tid = s + float(ev.get("dur", 0.0)), ev.get("tid")
        corr = (ev.get("args") or {}).get("correlation")
        if cat in trace.GPU_CATS:
            gpu.append((s, e, corr, name))
        elif cat in RUNTIME_CATS:
            runtime[tid].append((s, e))
            if corr is not None:
                launches[corr] = s
        elif cat in trace.HOST_CATS:
            if cat == "cpu_op":
                cpu_ops.append((s, e, tid, name))
                host.append((s, e, name))
            elif cat == "user_annotation" and name.startswith(PREFIXES):
                spans[name].append((s, e, tid))
    if gpu:
        ops = [(s, e, launches[corr], name) for s, e, corr, name in gpu if corr in launches]
    else:  # the CPU: its innermost operators are its kernels
        ops = [(s, e, s, name) for s, e, name in _innermost_leaves(cpu_ops)]
    order = {name: sorted(iv) for name, iv in spans.items()}
    starts = {name: [iv[0] for iv in ivs] for name, ivs in order.items()}
    out = Spans(units=units, count={name: len(iv) for name, iv in spans.items()})
    inside, op_us = Counter(), Counter()
    for s, e, at, op in ops:
        names = frozenset(n for n in order if _covering(order[n], starts[n], at) is not None)
        inside[names] += e - s
        op_us[names, op] += e - s
        out.generate_ops += "tq::generate" in names
    out.inside_us, out.op_us = dict(inside), dict(op_us)
    for s, e, tid in spans.get("tq::generate", ()):
        calls = [(max(a, s), min(b, e)) for a, b in runtime.get(tid, ()) if a < e and b > s]
        out.generate_host_us += (e - s) - _union_us(calls)
    out.idle_gaps = _named_gaps(gpu, launches, host, order, starts)
    return out


def _named_gaps(gpu, launches, host, order, starts) -> list:
    """The ten longest gaps between the card's busy intervals, each
    ``[host:<op>-in-<tq:: span>, seconds]``: the innermost host operator and
    ``tq::`` span around the launch that ended the gap."""
    host.sort()
    host_starts = [s for s, _, _ in host]
    merged = trace._union((s, e) for s, e, _, _ in gpu)
    first = {}
    for s, _, corr, _ in gpu:
        if corr in launches:
            first.setdefault(s, launches[corr])
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)[:10]
    named = []
    for gap, end in gaps:
        at = first.get(end)
        op, where = "unknown", "no_tq_span"
        if at is not None:
            i = bisect.bisect_right(host_starts, at) - 1
            while i >= 0 and host[i][1] < at:  # the latest-starting operator around ``at``
                i -= 1
            op = host[i][2] if i >= 0 else op
            held = [(iv[1] - iv[0], n) for n in order if n.startswith("tq::")
                    for iv in [_covering(order[n], starts[n], at)] if iv is not None]
            where = min(held)[1] if held else where
        tail = "-in-" + where
        named.append([f"host:{trace._clean(op)[:64 - 5 - len(tail)]}{tail}", gap / 1e6])
    return named
