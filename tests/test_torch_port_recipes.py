"""The port's training recipes against the JAX package on the CPU: AdamW with
the frozen-W mask and the non-finite guard against optax (from JAX states
carried over by ``utils.convert.load_flax_train_state``), one autoencoder
step and one classifier step with their gradients, the classifier's
confusion counts and macro metrics, and the device representation.

The JAX classifier takes its default route: at 256 tokens its attention is
the Pallas flash kernel (``_flash_forward``, and ``_bwd_dq_kernel`` and
``_bwd_dkdv_kernel`` through its ``custom_vjp``), in interpret mode on the
CPU.  Tolerance: f32 rtol 1e-4 / atol 1e-5; every gradient to 1e-3 of its
peak (``assert_grads_close``); the optimizer's parameters to 1e-6.
"""

import copy

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_models import load, small_unet_pair
from test_torch_port_train import tiny_ae_pair
from tqdne_tpu.models.classifier import Classifier as JaxClassifier
from tqdne_tpu.ops.representation import log_spectrogram_representation
from tqdne_tpu.train import state as jstate
from tqdne_tpu.train import steps as jsteps
from tqdne_tpu_torch.data.representation import Identity, LogSpectrogram
from tqdne_tpu_torch.models.classifier import Classifier
from tqdne_tpu_torch.ops.representation import device_representation_fn
from tqdne_tpu_torch.train.state import (
    TrainState,
    applied_updates,
    apply_updates,
    cosine_annealing,
    make_optimizer,
)
from tqdne_tpu_torch.train.steps import (
    autoencoder_losses,
    classifier_outputs,
    confusion_metrics,
    make_classifier_steps,
)
from tqdne_tpu_torch.utils import convert

RTOL, ATOL = 1e-4, 1e-5
TINY_CLF = dict(in_channels=3, model_channels=8, out_channels=16, channel_mult=(1, 2, 4, 4),
                attention_resolutions=(8,), num_res_blocks=1, dims=2, conv_kernel_size=3,
                num_heads=4)
NUM_CLASSES = 36


def _t(a):
    return torch.from_numpy(np.array(a))


def _sd(tree):
    return convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, tree))


def assert_grads_close(module, want_tree):
    """Every gradient of ``module`` within 1e-3 of the peak of JAX's, plus
    1e-6 of the largest peak for gradients that are zero up to rounding
    (a convolution's bias right before a GroupNorm, which removes it)."""
    want = _sd(want_tree)
    largest = max(w.abs().max().item() for w in want.values())
    for name, p in module.named_parameters():
        peak = want[name].abs().max().item()
        err = (p.grad - want[name]).abs().max().item()
        assert err <= 1e-3 * peak + 1e-6 * largest, (name, err, peak, largest)


def _grads(params, rng, nan_at=None):
    """Seeded gradients shaped like ``params`` (the frozen W's stopped at 0),
    with a NaN in one leaf when asked."""
    g = jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    g["params"]["time_embed"]["W"] = np.zeros_like(g["params"]["time_embed"]["W"])
    if nan_at:
        g["params"]["out_conv"]["bias"][0] = np.nan
    return jax.tree_util.tree_map(jnp.asarray, g)


def _port_update(port, grads, ema_decay):
    sd = _sd(grads)
    for name, p in port.model.named_parameters():
        if p.requires_grad:
            p.grad = sd[name].clone()
    apply_updates(port, ema_decay)


def _assert_state_equal(port, jax_state):
    for module, tree in ((port.model, jax_state.params), (port.ema, jax_state.ema_params)):
        want = _sd(tree)
        for name, t in module.state_dict().items():
            np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=name)  # NaNs must sit in the same places
    assert port.step == int(jax_state.step)


@pytest.fixture(scope="module")
def unet_pair():
    return small_unet_pair(seed=5)


def _carried_over(jax_state, port_unet, name, lr, weight_decay, schedule, skip=0):
    model = copy.deepcopy(port_unet)
    port = TrainState(model, make_optimizer(name, model, lr, weight_decay), schedule,
                      skip_nonfinite=skip)
    host = jax.tree_util.tree_map(np.asarray, jax_state)
    convert.load_flax_train_state(port, host.params, host.ema_params,
                                  *convert.optax_state_fields(host.opt_state),
                                  step=int(host.step))
    return port


def test_adamw_with_the_frozen_w_mask_matches_optax(rng, unet_pair):
    """optax ``adamw`` (weight decay 1e-2, W masked out) + the cosine schedule
    + EMA over five updates: two in JAX, then the state carried over and
    three more on each side.  The frozen W keeps its value on both."""
    _, params, port_unet = unet_pair
    tx = jstate.make_optimizer("adamw", jstate.cosine_annealing(1e-2, 6), weight_decay=1e-2)
    update = jax.jit(lambda state, g: jstate.apply_updates(state, g, tx, 0.9))
    grads = [_grads(params, rng) for _ in range(5)]
    state = jstate.TrainState.create(params, tx)
    for g in grads[:2]:
        state = update(state, g)
    port = _carried_over(state, port_unet, "adamw", 1e-2, 1e-2, cosine_annealing(1e-2, 6))
    assert port.step == 2 and int(applied_updates(port.optimizer)) == 2
    for g in grads[2:]:
        state = update(state, g)
        _port_update(port, g, 0.9)
    _assert_state_equal(port, state)
    assert int(applied_updates(port.optimizer)) == int(state.opt_state[0].count) == 5
    np.testing.assert_array_equal(port.model.time_embed.W.numpy(),
                                  np.asarray(params["params"]["time_embed"]["W"]))


def test_make_optimizer_takes_the_weight_decay_it_is_given(unet_pair):
    _, _, port_unet = unet_pair
    assert make_optimizer("adamw", port_unet, 1e-4).param_groups[0]["weight_decay"] == 0.0
    assert make_optimizer("adamw", port_unet, 1e-4, 1e-4).param_groups[0]["weight_decay"] == 1e-4
    with pytest.raises(ValueError, match="not ported"):
        make_optimizer("radam", port_unet, 1e-4)


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_the_guard_follows_optax_apply_if_finite(rng, unet_pair, name):
    """``skip_nonfinite=2`` against ``optax.apply_if_finite(tx, 2)``: clean,
    NaN (carried over here, one non-finite step counted), then clean, NaN,
    NaN, NaN.  A skipped step holds the parameters and the update count (so
    the schedule), moves the EMA and ``step``; the third NaN in a row is
    applied, NaNs included.  Compared after every step."""
    _, params, port_unet = unet_pair
    tx = jstate.make_optimizer(name, jstate.cosine_annealing(1e-2, 8),
                               weight_decay=1e-2 if name == "adamw" else 0.0, skip_nonfinite=2)
    update = jax.jit(lambda state, g: jstate.apply_updates(state, g, tx, 0.9))
    grads = [_grads(params, rng, nan_at=bad) for bad in (0, 1, 0, 1, 1, 1)]
    state = jstate.TrainState.create(params, tx)
    for g in grads[:2]:
        state = update(state, g)
    port = _carried_over(state, port_unet, name, 1e-2, 1e-2 if name == "adamw" else 0.0,
                         cosine_annealing(1e-2, 8), skip=2)
    assert port.notfinite_count.item() == 1 and int(applied_updates(port.optimizer)) == 1
    held = []
    for g in grads[2:]:
        state = update(state, g)
        _port_update(port, g, 0.9)
        _assert_state_equal(port, state)
        inner_count = convert.optax_state_fields(state.opt_state)[2]
        assert int(applied_updates(port.optimizer)) == inner_count
        assert port.notfinite_count.item() == int(state.opt_state.notfinite_count)
        held.append(inner_count)
    assert held == [2, 2, 2, 3]  # skipped, skipped, then the update is accepted
    assert torch.isnan(port.model.out_conv.bias).any()


def test_a_disarmed_guard_rejects_nothing():
    """A step the guard rejected leaves no mark on the fused optimizer: once
    ``skip_nonfinite`` is set back to 0, the next clean step is applied."""
    model = torch.nn.Linear(3, 2)
    state = TrainState(model, make_optimizer("adam", model, 1e-2), skip_nonfinite=2)

    def step(value):
        for p in model.parameters():
            p.grad = torch.full_like(p, value)
        apply_updates(state, 0.0)

    before = model.weight.detach().clone()
    step(float("nan"))
    assert torch.equal(model.weight, before) and int(applied_updates(state.optimizer)) == 0
    state.skip_nonfinite = 0
    step(1.0)
    assert not torch.equal(model.weight, before) and int(applied_updates(state.optimizer)) == 1


def test_the_schedule_follows_the_applied_count_after_the_guard_is_disarmed():
    """A step the guard rejected does not advance the schedule, armed or not
    afterwards: optax's inner count has not moved, so the next update runs
    at the schedule's first value while ``step`` is already 1."""
    model = torch.nn.Linear(3, 2)
    schedule = cosine_annealing(1e-2, 4)
    state = TrainState(model, make_optimizer("adam", model, 1e-2), schedule, skip_nonfinite=2)
    for value in (float("nan"), 1.0):
        for p in model.parameters():
            p.grad = torch.full_like(p, value)
        apply_updates(state, 0.0)
        state.skip_nonfinite = 0
    assert state.step == 2 and int(applied_updates(state.optimizer)) == 1
    assert float(state.optimizer.param_groups[0]["lr"]) == pytest.approx(1e-2, rel=1e-6)
    assert float(schedule(1)) < 1e-2


def test_a_checkpoint_without_the_guard_count_loads():
    """A state saved before the guard existed (no ``notfinite_count``) loads,
    with the count at 0."""
    model = torch.nn.Linear(3, 2)
    state = TrainState(model, make_optimizer("adam", model, 1e-2), skip_nonfinite=2)
    state.notfinite_count.fill_(2)
    saved = state.state_dict()
    del saved["notfinite_count"]
    state.load_state_dict(saved)
    assert state.notfinite_count.item() == 0


def test_autoencoder_step_matches_jax(rng):
    """One autoencoder step in eval mode: the reconstruction loss, the KL,
    the loss and every gradient against ``jax.value_and_grad`` of the JAX
    step's loss, with JAX's eps injected."""
    jae, params, port = tiny_ae_pair()
    signal = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    key = jax.random.key(7)
    _, eval_step = jsteps.make_autoencoder_steps(jae, optax.adam(1e-4), kl_weight=0.1)

    def loss(p):
        metrics = eval_step(jstate.TrainState(0, p, p, None), {"signal": jnp.asarray(signal)},
                            key)
        return metrics["loss"], metrics

    (_, want), want_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    eps = jax.random.normal(jax.random.split(key, 3)[0], (2, 8, 8, 8))
    got = autoencoder_losses(port.eval(), {"signal": _t(signal)}, kl_weight=0.1,
                             draws={"ae_eps": _t(eps)})
    got["loss"].backward()
    for k in ("reconstruction_loss", "kl_divergence", "loss"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    assert_grads_close(port, want_grads)
    with pytest.raises(ValueError, match="cond_signal"):
        autoencoder_losses(port, {"signal": _t(signal), "cond_signal": _t(signal)})


@pytest.fixture(scope="module")
def classifier_pair():
    jm = JaxClassifier(encoder_config=TINY_CLF, num_classes=NUM_CLASSES)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 128, 128, 3)))
    gen = np.random.default_rng(8)
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(gen.standard_normal(s.shape).astype(np.float32) * 0.1), shapes)
    return jm, params, load(Classifier(TINY_CLF, NUM_CLASSES), params)


def test_classifier_step_matches_jax_through_its_pallas_route(rng, classifier_pair):
    """One classifier step in eval mode at 128 x 128 (256 tokens at ds 8,
    where JAX's "auto" attention takes the Pallas kernel): the weighted
    cross-entropy, the accuracy and every gradient; then the eval step's
    confusion counts against JAX's eval step on the same batch."""
    jm, params, port = classifier_pair
    signal = rng.uniform(-1, 1, (4, 128, 128, 3)).astype(np.float32)
    label = rng.integers(0, NUM_CLASSES, 4).astype(np.int32)
    weights = rng.uniform(0.5, 2.0, NUM_CLASSES).astype(np.float32)
    batch = {"signal": jnp.asarray(signal), "label": jnp.asarray(label)}
    _, eval_step, _ = jsteps.make_classifier_steps(jm, optax.adam(1e-4), weights)
    key = jax.random.key(0)

    def loss(p):
        metrics = eval_step(jstate.TrainState(0, p, p, None), batch, key)
        return metrics["loss"], metrics

    (_, want), want_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    port_batch = {"signal": _t(signal), "label": _t(label)}
    _, got = classifier_outputs(port.eval(), port_batch, torch.from_numpy(weights))
    got["loss"].backward()
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=RTOL, atol=ATOL)
    assert got["accuracy"].item() == float(want["accuracy"])
    assert_grads_close(port, want_grads)

    _, port_eval, _ = make_classifier_steps(weights)
    counts = port_eval(TrainState(port, make_optimizer("adam", port, 1e-4)), port_batch)
    for k in ("tp_counts", "pred_counts", "true_counts"):
        np.testing.assert_array_equal(counts[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_confusion_metrics_match_jax_metric_postprocess(rng):
    """The macro metrics from the same epoch means (classes absent from the
    labels left out of the average), on both sides."""
    _, _, jax_post = jsteps.make_classifier_steps(
        JaxClassifier(encoder_config=TINY_CLF, num_classes=6), None, np.ones(6, np.float32))
    true = rng.integers(0, 4, 6).astype(np.float64)
    true[2] = 0  # an absent class
    means = {"loss": 1.25, "accuracy": 0.5, "true_counts": true,
             "tp_counts": np.minimum(true, rng.integers(0, 3, 6)),
             "pred_counts": rng.integers(0, 5, 6).astype(np.float64)}
    want = jax_post(dict(means))
    got = confusion_metrics(dict(means))
    assert set(got) == set(want) == {"loss", "accuracy", "macro_accuracy", "macro_precision",
                                     "macro_recall", "macro_f1"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


def test_device_representation_matches_jax(rng):
    """``device_representation_fn(LogSpectrogram)`` on channels-last
    waveforms against ``log_spectrogram_representation`` (the STFT's
    tolerance, atol 1e-4, as the host representation's test); Identity
    passes the waveform through."""
    wave = (rng.standard_normal((2, 4064, 3)) * 0.5).astype(np.float32)
    want = log_spectrogram_representation(jnp.asarray(wave), n_fft=256, hop=32)
    got = device_representation_fn(LogSpectrogram(stft_channels=256, hop_size=32))(_t(wave))
    assert got.shape == want.shape == (2, 128, 128, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-4)
    assert device_representation_fn(Identity())(_t(wave)) is not None
    torch.testing.assert_close(device_representation_fn(Identity())(_t(wave)), _t(wave))
    assert device_representation_fn(object()) is None
