"""Device milliseconds a batch in the autoencoder's decoder."""


def read(run):
    r = run["result"]
    ms = r.layer["trace"]["span_ms"].get("pb.decode")
    return None if ms is None else ms / r.units
