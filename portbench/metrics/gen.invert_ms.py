"""Device milliseconds a batch in the inversion to waveforms (de-normalising
and Griffin-Lim, or the envelope's inverse)."""


def read(run):
    r = run["result"]
    ms = r.layer["trace"]["span_ms"].get("pb.invert")
    return None if ms is None else ms / r.units
