"""Percent of the traced window in which no operation ran on the card."""


def read(run):
    r = run["result"]
    if r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.layer["trace"]["busy_s"] / r.window_s)
