"""The port's RAdam and consistency models against the JAX package on the CPU:
``make_optimizer("radam")`` against ``optax.radam`` across the first
rectified step, bare and inside ``apply_if_finite``; every function of
``diffusion/consistency.py`` with injected draws; the shared dropout masks of
teacher and student; the sampler at 1 and 2 network evals in both noise
conventions; one f32 train step of ``consistency`` and ``latent_consistency``
(loss, every gradient, the parameters after RAdam and the EMA); and the
``consistency`` CLI chain from training to serving.

Weights are flax ``init`` shapes drawn from a numpy seed and carried over by
the port's weight bridge; every draw is made on the JAX side as its function
makes it and injected.  The JAX UNet takes its default route (GroupNorm and
attention in plain XLA, the function the Pallas kernels compute; the kernel
routes are held in ``test_torch_port_models.py`` and ``test_torch_port_1d.py``).
Tolerance: f32 rtol 1e-4 / atol 1e-5 for functions; a step's loss to 1e-5
relative and every gradient (and every parameter's update) to 1e-3 of its
peak; the optimizer's parameters to 1e-6 (``_assert_state_equal``).
"""

import copy
import functools
import json

import h5py
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_1d import UNET_1D, assert_grads_close
from test_torch_port_models import SMALL_UNET, load, random_params
from test_torch_port_recipes import _assert_state_equal, _carried_over, _grads, _port_update
from test_torch_port_train import tiny_ae_pair
from tqdne_tpu.diffusion import consistency as jcons
from tqdne_tpu.models.unet import UNet as JaxUNet
from tqdne_tpu.train import state as jstate
from tqdne_tpu_torch.cli import common
from tqdne_tpu_torch.cli import evaluate as evaluate_cli
from tqdne_tpu_torch.cli import generate_waveforms
from tqdne_tpu_torch.cli import serve as serve_cli
from tqdne_tpu_torch.cli import train as train_cli
from tqdne_tpu_torch.diffusion import consistency as cons
from tqdne_tpu_torch.models.unet import UNet
from tqdne_tpu_torch.train.state import RAdam, TrainState, applied_updates, make_optimizer
from tqdne_tpu_torch.train.steps import training_sample
from tqdne_tpu_torch.utils import convert, fold_seed

RTOL, ATOL = 1e-4, 1e-5
CFG = jcons.ConsistencyConfig()
L_1D = 64  # the 1D UNet's signal: 32 tokens at its attention
TINY_2D = SMALL_UNET | {"model_channels": 16, "channel_mult": (1, 2)}  # over the 8x8x8 latent


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _sd(tree):
    return convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def pair_1d():
    """The consistency recipe's 1D UNet over (L_1D, 6), both sides, the
    JAX one on its default route."""
    cfg = UNET_1D | {"in_channels": 6, "out_channels": 6}
    jm = JaxUNet(**cfg)
    params = random_params(jm, jnp.zeros((1, L_1D, 6)), jnp.zeros((1,)), jnp.zeros((1, 5)),
                           seed=13, std=0.05)
    return jm, params, load(UNet(**cfg), params)


# ---- RAdam ---------------------------------------------------------------------------


@functools.cache
def _radam_update(skip: int):
    """``optax.radam`` at a constant 1e-2 (in ``apply_if_finite(_, skip)``
    where ``skip``) and its jitted update with EMA 0.9, compiled once a
    module."""
    tx = jstate.make_optimizer("radam", 1e-2, skip_nonfinite=skip)
    return tx, jax.jit(lambda state, g: jstate.apply_updates(state, g, tx, 0.9))


@pytest.mark.parametrize("nan_at, carried, want_counts", [
    ((), 2, [3, 4, 5, 6, 7, 8]),
    ((1, 4, 9, 10, 11), 2, [2, 3, 3, 4, 5, 6, 7, 7, 7, 8]),
    ((0, 4, 9, 10, 11), 0, [0, 1, 2, 3, 3, 4, 5, 6, 7, 7, 7, 8]),
], ids=["plain", "guarded", "guarded-from-the-first-step"])
def test_radam_matches_optax_radam_across_the_rectified_step(rng, pair_1d, nan_at, carried,
                                                             want_counts):
    """``make_optimizer("radam")`` at a constant 1e-2 against ``optax.radam``
    (bare, or in ``apply_if_finite(_, 2)`` with NaN gradients at the steps
    ``nan_at``): ``carried`` updates in JAX, the state carried over (its
    ``ScaleByAdamState`` read by ``optax_state_fields``), then the rest on
    each side, compared after every step.  The updates cross rho >= 5
    (rho_5 = 4.996, rho_6 = 5.994); the guarded runs skip two NaN steps and
    apply the third NaN step in a row, as optax does, and the last one
    rejects the very first step (count 0, where the bias corrections have
    no value) with the parameters and the moments held."""
    _, params, port_unet = pair_1d
    n = 12 if nan_at else 8
    tx, update = _radam_update(2 if nan_at else 0)
    grads = [_grads(params, rng, nan_at=k in nan_at) for k in range(n)]
    state = jstate.TrainState.create(params, tx)
    for g in grads[:carried]:
        state = update(state, g)
    port = _carried_over(state, port_unet, "radam", 1e-2, 0.0, None, skip=2 if nan_at else 0)
    assert isinstance(port.optimizer, RAdam)
    counts = []
    for g in grads[carried:]:
        state = update(state, g)
        _port_update(port, g, 0.9)
        _assert_state_equal(port, state)
        counts.append(convert.optax_state_fields(state.opt_state)[2])
        assert int(applied_updates(port.optimizer)) == counts[-1]
        assert float(port.optimizer.param_groups[0]["lr"]) == 1e-2  # no schedule
    assert counts == want_counts  # a NaN step skipped, the third in a row applied
    assert torch.isnan(port.model.out_conv.bias).any() == bool(nan_at)


def test_radam_keeps_optax_eps_placement():
    """One rectified update (step 6) on a tiny gradient, where torch's RAdam
    (eps on sqrt(nu) rather than sqrt(nu_hat)) moves the parameter by a
    visibly different amount: the port follows optax."""
    g = np.full(3, 1e-8, np.float32)
    p0 = np.zeros(3, np.float32)
    tx = optax.radam(1.0)
    update = jax.jit(tx.update)  # as a train step runs it: eager JAX rounds b2^t otherwise
    opt_state, p = tx.init(jnp.asarray(p0)), jnp.asarray(p0)
    port_p = torch.nn.Parameter(torch.zeros(3))
    torch_p = torch.nn.Parameter(torch.zeros(3))
    port, ref = RAdam([port_p], lr=1.0), torch.optim.RAdam([torch_p], lr=1.0)
    for _ in range(6):
        u, opt_state = update(jnp.asarray(g), opt_state, p)
        p = optax.apply_updates(p, u)
        for opt, q in ((port, port_p), (ref, torch_p)):
            q.grad = torch.from_numpy(g.copy())
            opt.step()
    np.testing.assert_allclose(port_p.detach().numpy(), np.asarray(p), rtol=1e-5)
    assert abs(torch_p[0].item() - float(p[0])) > 0.1 * abs(float(p[0]))


# ---- the functions -------------------------------------------------------------------


@pytest.mark.parametrize("step,max_steps", [(0, 1000), (124, 1000), (125, 1000), (999, 1000),
                                            (10**6, 1000), (0, 3), (5, 3), (7, 16)])
def test_schedule_matches_jax(step, max_steps):
    """N(k) (the doubling, and the s' >= 1 clamp of a run shorter than its 8
    doublings), the sigma grid at it and the masked log-PMF (-inf in the same
    places), and the boundary scalings."""
    n = cons.num_timesteps(cons.ConsistencyConfig(), step, max_steps)
    want_n = float(jcons.num_timesteps(CFG, step, max_steps))
    assert n == want_n
    i = np.arange(int(n), dtype=np.float32)
    np.testing.assert_allclose(cons.sigma_grid_value(cons.ConsistencyConfig(), _t(i), n).numpy(),
                               np.asarray(jcons.sigma_grid_value(CFG, jnp.asarray(i), want_n)),
                               rtol=RTOL, atol=ATOL)
    got = cons.timestep_log_pmf(cons.ConsistencyConfig(), n, 1280).numpy()
    want = np.asarray(jcons.timestep_log_pmf(CFG, want_n, 1280))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(got).sum() == n - 1
    # each probability is a difference of two f32 erf values near +-1, a few ulps
    # (6e-8) each: on the 1281-point grid the smallest are 1e-4, so compare in
    # probability, to 1e-6 absolute (the log of a 1e-4 one is ill-conditioned there)
    np.testing.assert_allclose(np.exp(got), np.exp(want), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(np.exp(got).sum(), 1.0, rtol=1e-5)
    sigma = np.array([0.002, 0.01, 1.0, 80.0], np.float32)
    for name in ("skip_scaling", "out_scaling"):
        np.testing.assert_allclose(getattr(cons, name)(cons.ConsistencyConfig(), _t(sigma)),
                                   getattr(jcons, name)(CFG, jnp.asarray(sigma)), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_timestep_draws_follow_the_masked_pmf():
    """Gumbel-max draws from a seeded generator: only intervals below N - 1,
    at the PMF's frequencies (20000 draws, within 0.01)."""
    n = 11.0
    log_pmf = cons.timestep_log_pmf(cons.ConsistencyConfig(), n, 1280)
    gen = torch.Generator().manual_seed(0)
    draws = cons.draw_categorical(log_pmf, 20000, gen)
    assert int(draws.max()) < n - 1
    freq = np.bincount(draws.numpy(), minlength=int(n) - 1) / len(draws)
    np.testing.assert_allclose(freq, np.exp(log_pmf[: int(n) - 1].numpy()), atol=0.01)


def matrix_net(lib, m):
    """A toy network whose output depends on each input channel's place
    (so the conditioning signal's concatenation order shows), on sigma and
    on the conditioning."""
    def net(x, sigma, c):
        s = sigma.reshape(-1, *(1,) * (x.ndim - 1))
        return lib.tanh(x @ m) * (1 + 0.1 * s) + c.sum(-1).reshape(s.shape)
    return net


def test_forward_and_loss_match_jax(rng):
    """``consistency_forward`` with a conditioning signal (``[x, cond_signal]``)
    and ``consistency_loss`` with its timesteps and noise drawn as JAX draws
    them, the teacher a different network, at N(7) of 16 steps."""
    x = rng.standard_normal((3, 8, 2)).astype(np.float32)
    cs = rng.standard_normal((3, 8, 1)).astype(np.float32)
    cond = rng.standard_normal((3, 5)).astype(np.float32)
    sigma = np.array([0.01, 1.0, 60.0], np.float32)
    m, m2 = (rng.standard_normal((3, 2)).astype(np.float32) for _ in range(2))
    want = jcons.consistency_forward(CFG, matrix_net(jnp, jnp.asarray(m)), jnp.asarray(x),
                                     jnp.asarray(sigma), jnp.asarray(cs), jnp.asarray(cond))
    got = cons.consistency_forward(cons.ConsistencyConfig(), matrix_net(torch, _t(m)), _t(x),
                                   _t(sigma), _t(cs), _t(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    swapped = cons.consistency_forward(cons.ConsistencyConfig(), matrix_net(torch, _t(m)),
                                       _t(cs[..., [0, 0]]), _t(sigma), _t(x[..., :1]), _t(cond))
    assert not np.allclose(swapped.numpy(), np.asarray(want), atol=1e-3)

    key = jax.random.key(4)
    want = jcons.consistency_loss(CFG, matrix_net(jnp, jnp.asarray(m2)),
                                  matrix_net(jnp, jnp.asarray(m)), key, jnp.asarray(x), 7, 16,
                                  cond_signal=jnp.asarray(cs), cond=jnp.asarray(cond))
    draws = consistency_draws(key, x.shape, cons.num_timesteps(cons.ConsistencyConfig(), 7, 16))
    got = cons.consistency_loss(cons.ConsistencyConfig(), matrix_net(torch, _t(m2)),
                                matrix_net(torch, _t(m)), _t(x), 7, 16, cond_signal=_t(cs),
                                cond=_t(cond), **draws)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


def consistency_draws(key, shape, n):
    """The timesteps and the noise of ``jcons.consistency_loss`` for ``key``."""
    def draw(key, n):
        key_t, key_eps = jax.random.split(key)
        return (jax.random.categorical(key_t, jcons.timestep_log_pmf(CFG, n, 1280),
                                       shape=(shape[0],)), jax.random.normal(key_eps, shape))

    timesteps, eps = jax.jit(draw)(key, n)
    return {"timesteps": _t(timesteps), "eps": _t(eps)}


# ---- dropout ---------------------------------------------------------------------------


def test_teacher_and_student_share_their_dropout_masks(rng):
    """At dropout 0.5, forward hooks on every dropout layer see the teacher's
    masks (first, without gradients) equal the student's, while two plain
    forwards draw different ones; the loss's gradient comes from the student."""
    unet = UNet(**(UNET_1D | {"in_channels": 6, "out_channels": 6, "dropout": 0.5})).train()
    masks = []

    def hook(mod, args, out):
        masks.append((out == 0) & (args[0] != 0))

    hooks = [m.register_forward_hook(hook) for m in unet.modules()
             if isinstance(m, torch.nn.Dropout)]
    x = _t(rng.standard_normal((2, L_1D, 6)).astype(np.float32))
    cond = _t(rng.standard_normal((2, 5)).astype(np.float32))
    torch.manual_seed(0)
    loss = cons.consistency_loss(cons.ConsistencyConfig(), unet, unet, x, 3, 100, cond=cond,
                                 generator=torch.Generator().manual_seed(1))
    k = len(hooks)
    assert k > 0 and len(masks) == 2 * k
    assert all(a.any() and torch.equal(a, b) for a, b in zip(masks[:k], masks[k:]))
    masks.clear()
    with torch.no_grad():
        unet(x, torch.ones(2), cond)
        unet(x, torch.ones(2), cond)
    assert any(not torch.equal(a, b) for a, b in zip(masks[:k], masks[k:]))
    for h in hooks:
        h.remove()
    loss.backward()
    assert unet.out_conv.weight.grad is not None


# ---- the sampler -----------------------------------------------------------------------


def sampler_draws(key, shape, sigmas, noise):
    """The initial and refinement draws of ``jcons.consistency_sample``."""
    key, sub = jax.random.split(key)
    eps = _t(jax.random.normal(sub, shape))
    refine = []
    for _ in sigmas:
        key, sub = jax.random.split(key)
        draw = jax.random.normal if noise == "song" else jax.random.uniform
        refine.append(_t(draw(sub, shape)))
    return eps, refine


@pytest.fixture(scope="module")
def jax_net_1d(pair_1d):
    """The JAX ``sample_fn``'s network over ``pair_1d``, jitted once for every
    case."""
    jm, params, _ = pair_1d
    return jax.jit(lambda x, s, c: jm.apply(params, x, s, c))


@pytest.mark.parametrize("nfe", [1, 2])
@pytest.mark.parametrize("noise", ["auto", "reference"])
def test_sampler_matches_jax(rng, pair_1d, jax_net_1d, noise, nfe):
    """``sample_consistency`` against JAX's ``consistency_sample`` at 1 and 2
    network evals, in the song ("auto") and reference conventions, the
    refinement at sigma 0.7, with JAX's draws injected."""
    port, net = pair_1d[2], jax_net_1d
    cond = rng.standard_normal((2, 5)).astype(np.float32)
    shape, sigmas, key = (2, L_1D, 6), (0.7,) * (nfe - 1), jax.random.key(17)
    want = jcons.consistency_sample(CFG, net, key, shape, sigmas, None, jnp.asarray(cond),
                                    noise=noise)
    eps, refine = sampler_draws(key, shape, sigmas, "reference" if noise == "reference"
                                else "song")
    got = cons.sample_consistency(port, shape, _t(cond), sigmas=sigmas, noise=noise, eps=eps,
                                  refine_draws=refine, device="cpu")
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(np.asarray(want)).max()))


# ---- the train steps -------------------------------------------------------------------


def encoder_eps(jae, ae_params, signal, key_ae) -> torch.Tensor:
    """The standard normal the JAX encoder draws from its ``sample`` key
    ``key_ae`` inside a step, at the latent's shape."""
    def draw(params, x, key):
        k_eps = jae.apply(params, x, method=lambda m, x: m.make_rng("sample"),
                          rngs={"sample": key})
        shape = jax.eval_shape(lambda: jae.apply(params, x, method="encode",
                                                 rngs={"sample": key})).shape
        return jax.random.normal(k_eps, shape)

    return _t(jax.jit(draw)(ae_params, signal, key_ae))


def jax_step(j_train, params, *args, step=0, ema_params=None):
    """The loss and every gradient of one JAX ``train_step`` ``j_train``
    (built on ``optax.sgd(1.0)``, at ``step``, its EMA at ``ema_params``): its
    own loss and key split; the gradients are the parameters less the
    parameters after its update (f32: a few ulps of the parameters)."""
    def run(params, ema_params, *args):
        state = jstate.TrainState.create(params, optax.sgd(1.0)).replace(
            step=jnp.asarray(step, jnp.int32), ema_params=ema_params)
        new, metrics = j_train(state, *args)
        return metrics["loss"], jax.tree_util.tree_map(lambda p, q: p - q, params, new.params)

    return jax.jit(run)(params, params if ema_params is None else ema_params, *args)


def as_flax(tree, sd: dict):
    """The port's tensors ``sd`` (named as its state dict; None for the frozen
    W's missing gradient) in the layout of the flax tree ``tree``."""
    def leaf(path, ref):
        *scope, name = [str(p.key) for p in path][1:]
        if scope and scope[-1] == "GroupNorm_0":
            scope, name = scope[:-1], {"scale": "weight", "bias": "bias"}[name]
        t = sd[".".join([*scope, "weight" if name == "kernel" else name])]
        if t is None:
            return jnp.zeros_like(ref)
        if name == "kernel":  # (O, I, K...) -> (K..., I, O)
            t = t.permute(*range(2, t.ndim), 1, 0)
        return jnp.asarray(t.detach().numpy())

    return jax.tree_util.tree_map_with_path(leaf, tree)


def check_step(port_step, state, want_loss, want_grads, grads_module, tx, ema_decay, params,
               ema_params=None):
    """The port's train step against JAX: every gradient (of ``grads_module``,
    after a backward of the same loss) to 1e-3 of its peak; the step's loss to
    1e-5 relative; the parameters and the EMA after the step to 1e-6 of JAX's
    ``apply_updates`` with ``tx`` and ``ema_decay`` on those gradients (the
    update compared on the same gradients: Adam's first step moves a
    parameter whose gradient is near eps by an amount that the gradient's
    rounding decides)."""
    assert_grads_close(grads_module, want_grads)
    grads = as_flax(params, {n: p.grad for n, p in grads_module.named_parameters()})
    ema_params = params if ema_params is None else ema_params
    want = jax.jit(lambda st, g: jstate.apply_updates(st, g, tx, ema_decay))(
        jstate.TrainState(0, params, ema_params, tx.init(params)), grads)
    got = port_step()
    np.testing.assert_allclose(got["loss"].item(), float(want_loss), rtol=1e-5)
    for module, tree in ((state.model, want.params), (state.ema, want.ema_params)):
        want_sd = _sd(tree)
        for name, t in module.state_dict().items():
            np.testing.assert_allclose(t.numpy(), want_sd[name].numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=name)


def check_consistency_step(jm, params, port, signal, cond, key, step, max_steps, jae=None,
                           ae_params=None, port_ae=None):
    """One f32 step of the JAX consistency ``train_step`` (its loss and
    gradients) against the port's with JAX's draws, then RAdam at 1e-4 and
    the EMA 0.999 (``check_step``)."""
    j_train, _, _ = jcons.make_consistency_steps(jm, optax.sgd(1.0), CFG, max_steps,
                                                 autoencoder=jae)
    batch = {"signal": jnp.asarray(signal), "cond": jnp.asarray(cond)}
    want_loss, want_grads = jax_step(j_train, params, batch, key,
                                     *((ae_params,) if jae is not None else ()), step=step)

    key_ae, _, key_cm = jax.random.split(key, 3)
    shape, draws = signal.shape, {}
    if jae is not None:
        draws["ae_eps"] = encoder_eps(jae, ae_params, batch["signal"], key_ae)
        shape = tuple(draws["ae_eps"].shape)
    draws |= consistency_draws(key_cm, shape, cons.num_timesteps(cons.ConsistencyConfig(), step,
                                                                  max_steps))
    pbatch = {"signal": _t(signal), "cond": _t(cond)}
    unet = copy.deepcopy(port).train()
    sample = training_sample(pbatch, autoencoder=port_ae, ae_eps=draws.get("ae_eps"))
    loss = cons.consistency_loss(cons.ConsistencyConfig(), unet, unet, sample, step, max_steps,
                                 cond=pbatch["cond"], timesteps=draws["timesteps"],
                                 eps=draws["eps"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)

    model = copy.deepcopy(port)
    st = TrainState(model, make_optimizer("radam", model, 1e-4))
    st.step = step
    train_step, _ = cons.make_consistency_steps(cons.ConsistencyConfig(), max_steps,
                                                autoencoder=port_ae)
    check_step(lambda: train_step(st, pbatch, draws=draws), st, want_loss, want_grads, unet,
               optax.radam(1e-4), 0.999, params)
    assert st.step == step + 1 and int(applied_updates(st.optimizer)) == 1


def test_consistency_train_step_matches_jax(rng, pair_1d):
    jm, params, port = pair_1d
    signal = rng.uniform(-1, 1, (2, L_1D, 6)).astype(np.float32)
    check_consistency_step(jm, params, port, signal,
                           rng.standard_normal((2, 5)).astype(np.float32),
                           jax.random.key(41), step=5, max_steps=16)


def test_latent_consistency_train_step_matches_jax(rng):
    """The frozen encoder inside the step (JAX's eps injected), then the
    latent UNet's consistency loss, at N(0) of 1000 steps."""
    jm = JaxUNet(**TINY_2D)
    params = random_params(jm, jnp.zeros((1, 8, 8, 8)), jnp.zeros((1,)), jnp.zeros((1, 5)),
                           seed=14, std=0.05)
    jae, ae_params, port_ae = tiny_ae_pair()
    signal = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    check_consistency_step(jm, params, load(UNet(**TINY_2D), params), signal,
                           rng.standard_normal((2, 5)).astype(np.float32), jax.random.key(42),
                           step=0, max_steps=1000, jae=jae, ae_params=ae_params,
                           port_ae=port_ae)


# ---- the CLIs --------------------------------------------------------------------------


def test_consistency_cli_chain(tmp_path, capsys):
    """``consistency`` (RAdam at a constant 1e-4: no ``lr`` in the metrics)
    for a step on a synthetic workdir; generate from its run with
    ``--solver consistency`` (rebuilt at its stored --tiny widths); serve it
    at the default 2 evals (a seeded row equal to the bundle's sampler's);
    evaluate it in the reference convention (the provenance's settings)."""
    wd = str(tmp_path)
    run = ["--workdir", wd, "--tiny", "--device", "cpu", "-b", "4", "--synthetic", "12",
           "--dtype", "f32"]
    state = train_cli.main(["consistency", *run, "--max-steps", "1"])
    assert isinstance(state.optimizer, RAdam) and state.lr_schedule is None
    assert float(state.optimizer.param_groups[0]["lr"]) == 1e-4
    assert int(applied_updates(state.optimizer)) == 1
    rows = [json.loads(line) for line in
            (tmp_path / "outputs" / "Consistency-MovingAvg" / "metrics.jsonl").open()]
    losses = [r for r in rows if "training/loss" in r]
    assert losses and "lr" not in losses[0] and np.isfinite(losses[0]["training/loss"])
    stored = json.loads((tmp_path / "outputs" / "Consistency-MovingAvg" / "checkpoints" /
                         "hparams.json").read_text())
    assert stored["kind"] == "consistency"

    out = tmp_path / "c.h5"
    generate_waveforms.main(["--solver", "consistency", "--config", "consistency", "--workdir",
                             wd, "--device", "cpu", "--num_samples", "2",
                             "--hypocentral_distance", "50", "--magnitude", "5", "--vs30",
                             "400", "--hypocentre_depth", "10", "--azimuthal_gap", "100",
                             "--outfile", str(out), "--dtype", "f32"])
    with h5py.File(out) as f:
        assert f["waveforms"].shape == (2, 3, 4064) and np.isfinite(f["waveforms"][:]).all()

    args = serve_cli.parse_args(["--config", "consistency", "--workdir", wd, "--device", "cpu",
                                 "--dtype", "f32", "--batch-size", "2", "--port", "0"])
    assert args.num_steps == 2
    server, batcher = serve_cli.build_server(args)
    try:
        bundle = common.build_inference("consistency", workdir=wd, dtype=torch.float32,
                                        num_steps=2, device="cpu")
        assert bundle.kind == "consistency" and bundle.unet.in_conv.out_channels == 32
        wave = batcher.generate(np.zeros((1, 5), np.float32), seed=3)
        want = bundle.sampler(2)(fold_seed(3, 0), np.zeros((1, 5), np.float32))[:1].numpy()
        assert wave.shape == (1, 3, 4064) and np.isfinite(want).all()
        # another thread may split the CPU's reductions differently: 1e-5 of the peak
        np.testing.assert_allclose(wave, want, rtol=0, atol=1e-5 * np.abs(want).max())
    finally:
        server.server_close()
        batcher.shutdown()

    evaluate_cli.main(["--workdir", wd, "--config", "consistency", "--device", "cpu",
                       "--dtype", "f32", "-b", "4", "--limit-batches", "1",
                       "--consistency-noise", "reference", "--refine-sigma", "0.5"])
    h5 = tmp_path / "evaluation" / "Consistency-MovingAvg-split_test-rank_0.h5"
    with h5py.File(h5) as f:
        prov = json.loads(f.attrs["provenance"])
        assert np.isfinite(f["predicted_waveform"][:]).all()
    assert (prov["num_steps"], prov["consistency_noise"], prov["refine_sigma"]) == (
        2, "reference", 0.5)
    capsys.readouterr()


@pytest.mark.parametrize("config,solver,num_steps,want", [
    ("latent_edm", "consistency", None, ("latent_consistency", 2)),
    ("latent_edm", "distill", 1, ("latent_distill", 1)),
    ("consistency", "heun", None, ("consistency", 2)),
    ("latent_distill", "distill", None, ("latent_distill", 2)),
    ("ddpm", "heun", None, ("ddpm", 25)),
    ("1d_edm", "dpmpp_2m", 10, ("1d_edm", 10)),
    ("1d_edm", "consistency", None, "consistency-model run"),
    ("latent_consistency", "distill", None, "distilled-consistency run"),
])
def test_solver_routing_follows_jax(config, solver, num_steps, want):
    """The generate, serve and evaluate CLIs' ``--solver`` routing (the JAX
    generate CLI's): the flagship to its few-eval counterpart, refusals of a
    mismatched ``--config``, and 2 evals by default for a few-eval recipe."""
    if isinstance(want, str):
        with pytest.raises(SystemExit, match=want):
            common.route_solver(config, solver, num_steps)
        with pytest.raises(SystemExit, match=want):
            serve_cli.parse_args(["--config", config, "--solver", solver, "--device", "cpu"])
    else:
        assert common.route_solver(config, solver, num_steps) == want
