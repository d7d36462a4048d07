"""Device milliseconds a step under the program's own range
``tq::group_norm_silu_backward`` (the GroupNorm backward's recompute)."""


def read(run):
    r = run["result"]
    ms = r.layer["trace"]["span_ms"].get("tq::group_norm_silu_backward")
    return None if ms is None else ms / r.units
