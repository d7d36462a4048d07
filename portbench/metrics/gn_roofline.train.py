"""The GroupNorm forward's share of its roofline, in percent: the least time
its bytes need at the card's bandwidth (input, scale and bias read once,
output written once) over the device time of the kernels launched inside
the ``Norm32`` spans.  Nothing is returned without such device time."""

from portbench.harness import flops


def read(run):
    r = run["result"]
    ms = r.layer["trace"]["span_ms"].get("pb.norm")
    if not ms or not r.layer.get("gn_bytes"):
        return None
    return 100.0 * (r.layer["gn_bytes"] / flops.PEAK_HBM_BYTES) / (ms / 1e3)
