"""Device-side forward representations: the port of
``tqdne_tpu/ops/representation.py:device_representation_fn``.

With ``--device-representation`` the loader ships raw waveforms and the
train step computes the signal on the tensor's device, so the host never
runs the STFT.  The math is the host classes' own (``data.representation``),
in the model's channels-last layout.
"""

from __future__ import annotations

from tqdne_tpu_torch.data import representation as host


def device_representation_fn(representation):
    """A function from channels-last (B, T, C) waveforms to the channels-last
    signal, float32 on the waveforms' device, equivalent to
    ``representation.get_representation``; None where the port has no
    device transform (the 1D family's envelope comes with its recipes)."""
    if isinstance(representation, host.Identity):
        return lambda wf: wf
    if isinstance(representation, host.LogSpectrogram):
        return lambda wf: representation.get_representation(wf.movedim(-1, 1)).movedim(1, -1)
    return None
