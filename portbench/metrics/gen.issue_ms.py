"""Host milliseconds to issue one batch: from the call into
``InferenceBundle.generate`` until it returns (untraced batches of the traced
run; the launch queue may be full, and then the host waits for the card)."""


def read(run):
    return run["result"].layer.get("issue_ms")
