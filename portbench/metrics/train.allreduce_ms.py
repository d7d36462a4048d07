"""Device milliseconds a step inside the program's ``tq::allreduce`` span on
rank 0: the gradients' all-reduce in ``apply_updates`` (NCCL's kernel and the
bucket's copies), in the kind's traced window."""


def read(run):
    r = run["result"]
    ms = r.layer["trace"]["span_ms"].get("tq::allreduce")
    return None if ms is None else ms / r.units
