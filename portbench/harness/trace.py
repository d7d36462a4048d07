"""Spans around the calls into each layer, recorded from the benchmark's own
files (thin wrappers and module forwards, never an edit to the program), and
the reduction of a profiler trace to per-span device time, the busy and idle
shares and the breakdown.

A kernel belongs to a span when the host call that launched it ran inside
the span (on any thread: a training step's backward launches from autograd's
thread while the step's span waits).  Device time is the kernels' own
durations; busy time is the union of every device operation's interval.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from collections import defaultdict

import torch

from portbench.harness import flops

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


class Recorder:
    """Counts of the work inside the spans: GroupNorm bytes and the attention
    forward's FLOPs and bytes, from each call's shapes."""

    def __init__(self):
        self.gn_bytes = 0
        self.attn_flops = 0
        self.attn_bytes = 0


def span(name: str):
    return torch.profiler.record_function(name)


def wrap_norms(module: torch.nn.Module, rec: Recorder, norm_cls) -> None:
    """Each ``norm_cls`` forward of ``module`` inside a ``pb.norm`` span."""
    for m in module.modules():
        if isinstance(m, norm_cls):
            def forward(x, _fwd=m.forward, _m=m):
                rec.gn_bytes += flops.group_norm_bytes(x.numel(), x.element_size(),
                                                       _m.weight.numel(),
                                                       _m.weight.element_size())
                with span("pb.norm"):
                    return _fwd(x)
            m.forward = forward


@contextlib.contextmanager
def wrapped_attention(module, rec: Recorder):
    """``module.flash_attention`` (the attention block's entry into the kernel)
    inside a ``pb.attn`` span while the context is open."""
    original = module.flash_attention

    def flash_attention(q, k, v, *args, **kwargs):
        b, length, heads, d = q.shape
        f, nbytes = flops.attention_cost(b, length, heads, d, q.element_size())
        rec.attn_flops += f
        rec.attn_bytes += nbytes
        with span("pb.attn"):
            return original(q, k, v, *args, **kwargs)

    module.flash_attention = flash_attention
    try:
        yield
    finally:
        module.flash_attention = original


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


def trace_events(prof) -> list:
    """The profiler's trace events (its chrome trace, written to a temporary
    file under TMPDIR and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _union(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _clean(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", name)[:64]


def reduce(events: list, spans=("pb.",), extra_spans=()) -> dict:
    """From trace events: ``span_ms`` {span name: device ms of the kernels it
    launched}, ``busy_s``, ``device_ops`` and ``idle_gaps`` (the ten largest of
    each, seconds), and ``attributed`` (the share of kernel time whose launch
    was found)."""
    gpu, launches, host, marks = [], {}, [], defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        corr = (ev.get("args") or {}).get("correlation")
        if cat in GPU_CATS:
            gpu.append((ts, ts + dur, name, corr))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if corr is not None:
                launches[corr] = ts
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, name))
            if cat == "user_annotation" and (name.startswith(spans) or name in extra_spans):
                marks[name].append((ts, ts + dur))
    for name in marks:
        marks[name].sort()
    starts = {name: [s for s, _ in iv] for name, iv in marks.items()}
    span_us, total_us, attributed_us = defaultdict(float), 0.0, 0.0
    by_name = defaultdict(float)
    for s, e, name, corr in gpu:
        total_us += e - s
        by_name[name] += e - s
        at = launches.get(corr)
        if at is None:
            continue
        attributed_us += e - s
        for mark, iv in marks.items():
            i = bisect.bisect_right(starts[mark], at) - 1
            if i >= 0 and iv[i][0] <= at <= iv[i][1]:
                span_us[mark] += e - s
    merged = _union((s, e) for s, e, _, _ in gpu)
    busy_us = sum(e - s for s, e in merged)
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)[:10]
    first_launch = {}
    for s, _, _, corr in gpu:
        if corr in launches:
            first_launch.setdefault(s, launches[corr])
    idle = []
    for gap, end in gaps:
        at = first_launch.get(end)
        inner = None
        if at is not None:
            covering = [(e - s, n) for s, e, n in host if s <= at <= e]
            inner = min(covering)[1] if covering else None
        idle.append([f"host:{_clean(inner) if inner else 'unknown'}", gap / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"span_ms": {k: v / 1e3 for k, v in span_us.items()},
            "busy_s": busy_us / 1e6,
            "device_ops": [[_clean(n), t / 1e6] for n, t in ops],
            "idle_gaps": idle,
            "attributed": attributed_us / total_us if total_us else None}
