"""Training samples per second: every sample of the whole steps the window
completed, over the window (its start to the end of its last step)."""


def read(run):
    r = run["result"]
    return r.units * r.unit_size / r.window_s if r.window_s > 0 else None
