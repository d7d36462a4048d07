"""The attention forward's share of its roofline, in percent: the larger of
its FLOPs over the bf16 peak and its bytes (q, k, v read, the output
written) over the bandwidth, over the device time of the kernels launched
inside the spans around the block's call into ``flash_attention``."""

from portbench.harness import flops


def read(run):
    r = run["result"]
    ms = r.layer["trace"]["span_ms"].get("pb.attn")
    if not ms or not r.layer.get("attn_bytes"):
        return None
    bound = max(r.layer["attn_flops"] / flops.PEAK_BF16_FLOPS,
                r.layer["attn_bytes"] / flops.PEAK_HBM_BYTES)
    return 100.0 * bound / (ms / 1e3)
