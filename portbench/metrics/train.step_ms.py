"""Device milliseconds a training step (forward, backward, Adam and the EMA)."""


def read(run):
    r = run["result"]
    ms = r.layer["trace"]["span_ms"].get("pb.step")
    return None if ms is None else ms / r.units
