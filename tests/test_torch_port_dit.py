"""The ``latent_dit`` recipe's DiT (``models/dit.py``) on the CPU against the
plain float32 reference of ``tests/dit_reference.py``, on seeded random
weights (the adaLN and final layers that DiT initialises to zero included):
the forward, a Heun chain through ``build_inference``, one train step's loss
and gradients, the parameter count at the published widths, the refusals of
``--int8`` and ``--spatial`` and the CLI round trip train -> generate."""

import json

import h5py
import numpy as np
import pytest
import torch

import dit_reference as ref
from tqdne_tpu_torch import configs
from tqdne_tpu_torch.cli import common, export_weights, generate_waveforms
from tqdne_tpu_torch.cli import train as train_cli
from tqdne_tpu_torch.models.dit import DiT, sincos_2d
from tqdne_tpu_torch.train.state import TrainState
from tqdne_tpu_torch.train.steps import edm_step_loss, make_edm_steps
from tqdne_tpu_torch.utils import randomize_

RTOL, ATOL = 1e-4, 1e-5  # the port's f32 parity bar
# heads of 24: a head dimension that is not a power of two, as the published 72
SMALL = dict(input_size=8, patch_size=2, in_channels=8, out_channels=8, hidden_size=96,
             depth=2, num_heads=4, mlp_ratio=4.0, frequency_embedding_size=32, cond_features=5)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def weights(module) -> dict:
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def small_dit(seed=3):
    return randomize_(DiT(**SMALL), seed)


def test_positions_are_the_published_sincos():
    torch.testing.assert_close(sincos_2d(96, 4), ref.pos_embed(96, 4), rtol=0, atol=1e-7)


def test_forward_matches_reference():
    model = small_dit()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 8, 8, generator=gen)
    t, cond = torch.randn(2, generator=gen), torch.randn(2, 5, generator=gen)
    want = ref.dit(weights(model), SMALL, x, t, cond)
    got = model(x, t, cond)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert want.abs().mean() > 0.1  # every block contributes
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_heun_chain_through_build_inference():
    """Heun-3 (5 evaluations) of the ``--tiny`` bundle's DiT on the
    autoencoder's 8 x 32 x 32 latent, against the reference's chain from the
    same noise (the decoder left out: the chain is the latent's)."""
    bundle = common.build_inference("latent_dit", device="cpu", tiny=True, num_steps=3,
                                    solver="heun", dtype=torch.float32, gl_iters=1)
    net = bundle.unet
    assert isinstance(net, DiT) and bundle.model_shape == (32, 32, 8)
    cfg = configs.get_dit_config(bundle.config, 8) | common.TINY_DIT
    gen = torch.Generator().manual_seed(1)
    noise = torch.randn(2, *bundle.model_shape, generator=gen)
    cond = torch.randn(2, 5, generator=gen)
    bundle.autoencoder = None
    before = DiT.forwards
    got = bundle.sample(cond, noise=noise)
    assert DiT.forwards - before == 5
    P = weights(net)
    want = ref.heun(lambda x, t: ref.dit(P, cfg, x, t, cond), noise, 3)
    # one evaluation agrees to 2e-7 of its norm; the chain's steps from sigma 80 carry that
    # to about 1e-5, so the chain is held to the parity bar over its peak
    assert (got - want).norm() < RTOL * want.norm()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=RTOL * float(want.abs().max()))


def test_train_step_loss_and_gradients_match_reference():
    """One ``latent_dit`` step's loss and every gradient against autograd
    over the reference, the draws injected; then the step itself (SGD at 1
    moves every parameter by its gradient)."""
    model = small_dit(5)
    gen = torch.Generator().manual_seed(2)
    batch = {"signal": torch.randn(3, 8, 8, 8, generator=gen),
             "cond": torch.randn(3, 5, generator=gen)}
    draws = {"sigma_eps": torch.randn(3, generator=gen),
             "noise": torch.randn(3, 8, 8, 8, generator=gen)}
    P = {k: v.requires_grad_(not k.endswith(".W")) for k, v in weights(model).items()}
    want = ref.edm_loss(lambda x, t: ref.dit(P, SMALL, x, t, batch["cond"]), batch["signal"],
                        draws["sigma_eps"], draws["noise"])
    want.backward()
    loss = edm_step_loss(model, batch, draws=draws)
    loss.backward()
    torch.testing.assert_close(loss, want.detach(), rtol=RTOL, atol=ATOL)
    grads = {k: p.grad for k, p in model.named_parameters() if p.requires_grad}
    assert set(grads) == {k for k, v in P.items() if v.requires_grad}
    for k, g in grads.items():
        scale = P[k].grad.abs().max()
        torch.testing.assert_close(g, P[k].grad, rtol=RTOL, atol=ATOL * max(1.0, scale),
                                   msg=k)
    model.zero_grad(set_to_none=True)
    theta0 = weights(model)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=1.0), None)
    train_step, _ = make_edm_steps()
    out = train_step(state, batch, draws=draws)
    torch.testing.assert_close(out["loss"], want.detach(), rtol=RTOL, atol=ATOL)
    for k, p in model.named_parameters():
        if p.requires_grad:
            torch.testing.assert_close(theta0[k] - p.detach(), P[k].grad, rtol=1e-3,
                                       atol=1e-6, msg=k)


def test_published_parameter_count():
    """DiT-XL/2 at its published widths over the 8-channel latent: 675,035,296
    parameters (128 of them the frozen Fourier frequencies), built on ``meta``."""
    recipe = common.RECIPES["latent_dit"]
    with torch.device("meta"):
        net, cfg = common.build_network(recipe, configs.LatentSpectrogramConfig(), 8)
    assert (cfg["hidden_size"], cfg["depth"], cfg["num_heads"], cfg["patch_size"]) == (
        1152, 28, 16, 2)
    assert sum(p.numel() for p in net.parameters()) == 675_035_296
    assert net.blocks[0].mlp.fc1.out_features == 4608


@pytest.mark.parametrize("option", [dict(int8=True), dict(spatial=2)])
def test_int8_and_spatial_refused(option):
    with pytest.raises(SystemExit, match="latent_dit"):
        common.build_inference("latent_dit", device="cpu", tiny=True, **option)
    flag = ["--int8"] if "int8" in option else ["--spatial", "2"]
    with pytest.raises(SystemExit, match="latent_dit"):
        generate_waveforms.main(["--config", "latent_dit", "--unet-weights", "x.pt",
                                 "--ae-weights", "y.pt", "--outfile", "z.h5", "--device", "cpu",
                                 *flag])


def test_cli_round_trip(tmp_path):
    """``train autoencoder`` and ``train latent_dit`` one ``--tiny`` step each,
    then ``build_inference`` from the run and from its exported artifact, and
    ``generate-waveforms --config latent_dit`` from the runs, all without
    ``--tiny``: the networks are rebuilt at the widths the runs store, the
    DiT's under ``dit``."""
    wd = str(tmp_path)
    run = ["--workdir", wd, "--tiny", "--device", "cpu", "-b", "2", "--synthetic", "12",
           "--max-steps", "1", "--dtype", "f32"]
    train_cli.main(["autoencoder", *run])
    state = train_cli.main(["latent_dit", *run])
    assert state.step == 1
    hparams = json.loads((tmp_path / "outputs" / "Latent-DiT-XL2-32x32x8-LogSpectrogram" /
                          "checkpoints" / "hparams.json").read_text())
    assert "unet" not in hparams and hparams["dit"]["hidden_size"] == 96
    bundle = common.build_inference("latent_dit", workdir=wd, dtype=torch.float32,
                                    device="cpu", num_steps=2)
    assert bundle.unet.blocks[0].mlp.fc1.in_features == 96 and len(bundle.unet.blocks) == 2
    for name, t in bundle.unet.state_dict().items():
        torch.testing.assert_close(t, state.ema.state_dict()[name], msg=name)
    artifact = export_weights.export_weights("latent_dit", wd, tmp_path / "weights", "f32")
    exported = common.build_inference("latent_dit", workdir=wd, exported_weights=artifact,
                                      dtype=torch.float32, device="cpu")  # the manifest's widths
    for name, t in exported.unet.state_dict().items():
        torch.testing.assert_close(t, state.ema.state_dict()[name], msg=name)
    out = tmp_path / "dit.h5"
    generate_waveforms.main(["--config", "latent_dit", "--workdir", wd, "--outfile", str(out),
                             "--hypocentral_distance", "50", "--magnitude", "5.5", "--vs30",
                             "400", "--hypocentre_depth", "20", "--azimuthal_gap", "100",
                             "--num_samples", "2", "--batch_size", "2", "--num_steps", "2",
                             "--gl-iters", "2", "--dtype", "f32", "--device", "cpu"])
    with h5py.File(out) as f:
        wave = f["waveforms"][:]
    assert wave.shape == (2, 3, 4064) and np.isfinite(wave).all()
