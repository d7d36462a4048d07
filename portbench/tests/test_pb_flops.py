"""The operation counts of ``mfu.*`` against ``torch.utils.flop_counter`` over
the plain reference at small widths, and the byte counts of the rooflines."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import flops, inputs
from portbench.reference import diffusion, nets, shapes
from portbench.tests.conftest import BENCH


def small(config: str, m: int) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    cfg["unet"]["model_channels"] = m
    if "autoencoder" in cfg:
        for part in ("encoder", "decoder"):
            cfg["autoencoder"][part]["model_channels"] = m
    return cfg


def weights(shape_dict, requires_grad=False):
    gen = torch.Generator().manual_seed(0)
    P = inputs.make_weights(shape_dict, gen, "cpu")
    for k, v in P.items():
        v.requires_grad_(requires_grad and not k.endswith(".W"))
    return P


def counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


CASES = [("latent_edm", 16, (2, 8, 8, 8)), ("1d_edm", 16, (2, 64, 6))]


@pytest.mark.parametrize("config,m,shape", CASES)
def test_unet_forward_flops(config, m, shape):
    cfg = small(config, m)
    P = weights(shapes.unet(cfg["unet"]))
    x, t, c = torch.randn(shape), torch.randn(shape[0]), torch.randn(shape[0], 5)
    with torch.no_grad():
        got = counted(lambda: nets.unet(P, cfg["unet"], x, t, c))
    assert got == sum(flops.unet_forward(cfg["unet"], shape[0], shape[1:-1]).values())


@pytest.mark.parametrize("config,m,shape", CASES)
def test_unet_train_step_flops(config, m, shape):
    cfg = small(config, m)
    P = weights(shapes.unet(cfg["unet"]), requires_grad=True)
    x, e, c = torch.randn(shape), torch.randn(shape[0]), torch.randn(shape[0], 5)

    def step():
        net = lambda y, t: nets.unet(P, cfg["unet"], y, t, c)  # noqa: E731
        diffusion.loss(net, x, e, torch.randn(shape)).backward()

    assert counted(step) == flops.unet_train_step(cfg["unet"], shape[0], shape[1:-1])


def test_decoder_flops():
    cfg = small("latent_edm", 16)
    P = weights(shapes.autoencoder(cfg["autoencoder"]))
    z = torch.randn(2, 8, 8, 8)
    with torch.no_grad():
        got = counted(lambda: nets.decode(P, cfg["autoencoder"]["decoder"], z))
    assert got == flops.decoder_forward(cfg["autoencoder"]["decoder"], 2, (8, 8))


def test_full_width_counts():
    """The published widths' counts, as PERF.md quotes them."""
    latent = json.loads((BENCH / "configs" / "latent_edm.json").read_text())
    one_d = json.loads((BENCH / "configs" / "1d_edm.json").read_text())
    assert sum(flops.unet_forward(latent["unet"], 1, (32, 32)).values()) == 16_978_547_712
    assert flops.decoder_forward(latent["autoencoder"]["decoder"], 1, (32, 32)) == 27_206_352_896
    assert sum(flops.unet_forward(one_d["unet"], 1, (4064,)).values()) == 28_436_056_576
    assert flops.unet_train_step(one_d["unet"], 1, (4064,)) == 85_292_528_640


def test_roofline_bytes():
    assert flops.group_norm_bytes(10, 2, 4, 4) == 2 * 10 * 2 + 2 * 4 * 4
    f, b = flops.attention_cost(2, 16, 4, 128, 2)
    assert f == 4 * 2 * 4 * 16 * 16 * 128 and b == 4 * 2 * 16 * 4 * 128 * 2


def test_reference_parameter_count():
    latent = json.loads((BENCH / "configs" / "latent_edm.json").read_text())
    count = sum(torch.Size(s).numel() for s in shapes.unet(latent["unet"]).values())
    assert count == latent["unet_parameters"]
