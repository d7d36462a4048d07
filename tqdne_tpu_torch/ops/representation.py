"""Device-side forward representations: the port of
``envelope_representation`` and ``device_representation_fn`` in
``tqdne_tpu/ops/representation.py``.

With ``--device-representation`` the loader ships raw waveforms and the
train step computes the signal on the tensor's device, so the host never
runs the STFT or the envelope.  The math is the host classes' own
(``data.representation``), in the model's channels-last layout.
"""

from __future__ import annotations

import torch

from tqdne_tpu_torch.data import representation as host


def envelope_representation(waveform_cl: torch.Tensor, window: int = 128,
                            log_eps: float = 1e-6, eps: float = 1e-6) -> torch.Tensor:
    """Channels-last (B, T, C) waveforms -> (B, T, 2C) float32 signal: the
    scaled waveform and the shifted log envelope.  The running sum is taken
    in float64 on the waveforms' device, as on the host: the JAX transform
    differences a float32 running sum, which cancels where a waveform is
    quiet (the envelope's 1e-6 floor then amplifies the error)."""
    rep = host.MovingAverageEnvelope(window, log_eps, eps)
    return rep.get_representation(waveform_cl.movedim(-1, -2)).movedim(-2, -1)


def device_representation_fn(representation):
    """A function from channels-last (B, T, C) waveforms to the channels-last
    signal, float32 on the waveforms' device, equivalent to
    ``representation.get_representation``; None where the port has no
    device transform."""
    if isinstance(representation, host.Identity):
        return lambda wf: wf
    if isinstance(representation, host.LogSpectrogram):
        return lambda wf: representation.get_representation(wf.movedim(-1, 1)).movedim(1, -1)
    if isinstance(representation, host.MovingAverageEnvelope):
        return lambda wf: envelope_representation(wf, representation.window_size,
                                                  representation.log_eps, representation.eps)
    return None
