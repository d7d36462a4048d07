"""Model FLOPs done in the traced window (from the configuration's shapes:
convolutions, linear layers, attention) over the window times the card's
published bf16 peak, in percent."""

from portbench.harness import flops


def read(run):
    r = run["result"]
    if r.window_s <= 0 or not r.layer.get("model_flops"):
        return None
    return 100.0 * r.layer["model_flops"] / (r.window_s * flops.PEAK_BF16_FLOPS)
