"""Device milliseconds a batch in the sampler (the UNet evaluations through
the preconditioning and the solver's arithmetic), its decode taken out."""


def read(run):
    r = run["result"]
    span = r.layer["trace"]["span_ms"]
    if "pb.sample" not in span:
        return None
    return (span["pb.sample"] - span.get("pb.decode", 0.0)) / r.units
