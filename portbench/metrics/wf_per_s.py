"""Waveforms delivered to host memory per second: every waveform of the batches
issued in the window, over the window (its start to the moment the last of
them has reached host memory)."""


def read(run):
    r = run["result"]
    return r.units * r.unit_size / r.window_s if r.window_s > 0 else None
