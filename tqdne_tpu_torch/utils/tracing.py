"""Spans of the port's layers, on the profiler's clock.

``span(name)`` marks one layer's work in a ``torch.profiler`` trace.  While a
profiler records, it is ``torch.profiler.record_function("tq::" + name)``: a
``user_annotation`` event in the same trace as the kernels, on the same
clock, so every kernel falls inside or outside it by the time of its launch
(on any thread: a backward's kernels launch from autograd's thread while
``tq::backward`` waits), and every idle gap by the launch that ends it.  With
no profiler running it is one shared no-op context: one read of torch's own
flag and no dispatcher call.  The profiler being on is the only switch.

The spans, outermost first (each wraps the call at that place, nothing finer):

- ``tq::generate``: ``InferenceBundle.generate``, one batch, sample and invert;
  ``tq::sample``: ``InferenceBundle.sample``, the sampler and its decode;
  ``tq::denoise``: one network evaluation of a sampler (the EDM preconditioning
  and the UNet, or the consistency and DDPM samplers' network call);
  ``tq::decode``: ``AutoencoderKL.decode``; ``tq::invert``:
  ``InferenceBundle.invert`` (Griffin-Lim, or the envelope's inverse).
- ``tq::conv``: one convolution with its casts and bias (int8 and halo paths
  too); ``tq::conv_bias``: inside it, the in-place add of the bias and of a
  ResBlock's embedding shift (``ops.conv_bias``; not on the int8 path);
  ``tq::norm``: ``Norm32``, its layout moves and casts and the
  GroupNorm; ``tq::group_norm_silu``: the GroupNorm itself;
  ``tq::group_norm_silu_backward``: its backward's recompute;
  ``tq::attention``: the attention block's call into ``flash_attention``.
- The DiT's (``models.dit``): ``tq::modulate``: each LayerNorm with its
  per-sample modulation and each gated residual add (``nn.layers.modulate``,
  ``gated_add``); ``tq::mlp``: each block's MLP (fc1, tanh-GELU, fc2);
  ``tq::attn_proj``: the token attention's qkv and output projections (its
  ``flash_attention`` call stays in ``tq::attention``).  The counter
  ``DiT.forwards`` counts the network's forward calls.
- ``tq::loss``, ``tq::backward``: a recipe's ``train_step``, its forward with
  the draws and the loss, then ``loss.backward()``; ``tq::update``:
  ``apply_updates`` (the gradient all-reduce, the guard, the optimizer,
  ``zero_grad`` and the EMA); ``tq::allreduce``: the all-reduce of the
  gradients inside it (recorded at world size 1 too, where it issues
  nothing).
- ``tq::fit.load``, ``tq::fit.step``, ``tq::fit.log``: ``Trainer.fit``'s
  ``next(loader)``, its call of the step and the logging sync;
  ``Trainer(profile_steps=)`` records a window of them.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """``tq::<name>`` while a profiler records, else a shared no-op context."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function("tq::" + name)
    return _OFF
