"""The DiT modulation's share of its roofline, in percent: the least time its
bytes need at the card's bandwidth (each LayerNorm + modulation reading and
writing its tokens once, each gated residual reading two streams and writing
one, the per-sample vectors read once; ``harness/dit_flops.py``) over the
device time of the kernels launched inside the program's ``tq::modulate``
spans."""

from portbench.harness import flops


def read(run):
    r = run["result"]
    ms = r.layer["trace"]["span_ms"].get("tq::modulate")
    if not ms or not r.layer.get("modulate_bytes"):
        return None
    return 100.0 * (r.layer["modulate_bytes"] / flops.PEAK_HBM_BYTES) / (ms / 1e3)
