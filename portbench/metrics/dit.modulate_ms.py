"""Device milliseconds a DiT evaluation inside the program's ``tq::modulate``
spans (every LayerNorm with its per-sample modulation and every gated
residual add), in the kind's traced window."""


def read(run):
    r = run["result"]
    ms = r.layer["trace"]["span_ms"].get("tq::modulate")
    return None if ms is None or not r.layer.get("evals") else ms / r.layer["evals"]
