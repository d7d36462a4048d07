"""Device milliseconds a DiT evaluation inside the program's ``tq::mlp`` spans
(each block's fc1, tanh-GELU and fc2), in the kind's traced window."""


def read(run):
    r = run["result"]
    ms = r.layer["trace"]["span_ms"].get("tq::mlp")
    return None if ms is None or not r.layer.get("evals") else ms / r.layer["evals"]
