"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from the
root of the checkout.  Tests marked ``card`` need a CUDA card and skip without
one (the decision is made inside the fixture, never at import)."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "portbench"


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny_cell(name: str, *, dtype=None, limits=None, **traffic_over):
    """The committed cell ``name`` at widths a CPU test holds: the 2D presets
    at 32 channels (the 1D UNet keeps its published 64, whose GroupNorm groups
    hold two channels, as at full size) and a small batch."""
    from portbench.harness import registry

    cell = registry.load_cell(ROOT, name)
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    cfg.pop("unet_parameters", None)
    if cfg["unet"]["dims"] == 2:
        cfg["tiny"] = True
        cfg["unet"]["model_channels"] = 32
        for part in ("encoder", "decoder"):
            cfg["autoencoder"][part]["model_channels"] = 32
    if dtype is not None:
        cfg["dtype"] = dtype
    tr.update(traffic_over)
    cell.config, cell.traffic = cfg, tr
    cell.limits = dict(limits or cell.limits)
    return cell


GEN = {"latent": ("latent_edm.generate",
                  dict(batch=2, num_steps=3, griffin_lim_iters=4, check_rows_per_batch=1,
                       check_rows=2, reference_block=2, trace_batches=1)),
       "1d": ("1d_edm.generate",
              dict(batch=2, num_steps=3, check_rows_per_batch=1, check_rows=2,
                   reference_block=2, trace_batches=1))}
TRAIN = ("1d_edm.train", dict(batch=4, dataset_rows=16, reference_block=2, trace_steps=1))
