"""The ranks of ``tests/test_torch_port_parallel.py``: four processes over
gloo on the CPU, started once by its module fixture.  Each rank reads the
cases the test wrote (``inputs.pt``: weights, global batches and the JAX
step's global draws), runs the port's data-parallel paths on its rows and
writes what it got to ``rank<r>.pt``, which the test holds against the
1-rank port and the JAX package.  Imports no JAX."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from tqdne_tpu_torch.cli import evaluate
from tqdne_tpu_torch.data.dataset import Dataset
from tqdne_tpu_torch.data.pipeline import BatchLoader
from tqdne_tpu_torch.data.representation import Identity
from tqdne_tpu_torch.diffusion import ddpm
from tqdne_tpu_torch.diffusion.consistency import ConsistencyConfig, make_consistency_steps
from tqdne_tpu_torch.models.autoencoder import AutoencoderKL
from tqdne_tpu_torch.models.classifier import Classifier
from tqdne_tpu_torch.models.unet import UNet
from tqdne_tpu_torch.parallel import (draw_rows, local_batch_slice, make_hybrid_mesh, make_mesh,
                                      rank, world_size)
from tqdne_tpu_torch.parallel.fsdp import fsdp_shardings, shard_model, shard_with_ema
from tqdne_tpu_torch.train import checkpoint
from tqdne_tpu_torch.train.callbacks import SamplingEvalCallback
from tqdne_tpu_torch.train.loop import Trainer
from tqdne_tpu_torch.train.state import TrainState, cosine_annealing, make_optimizer
from tqdne_tpu_torch.train.steps import (make_autoencoder_steps, make_classifier_steps,
                                         make_edm_steps)

MAX_STEPS = 100  # the consistency schedule's and the cosine schedule's horizon
FSDP_MIN_SIZE = 2**12


def build_model(case: dict) -> torch.nn.Module:
    """The case's port module, with its weights."""
    kind, cfg = case["model"]
    if kind == "unet":
        model = UNet(**cfg)
    elif kind == "autoencoder":
        model = AutoencoderKL(*cfg)
    else:
        model = Classifier(*cfg)
    model.load_state_dict(case["state_dict"])
    return model


def make_steps(recipe: str, case: dict):
    """(train_step, eval_step) of the recipe, as the train CLI builds them."""
    if recipe == "autoencoder":
        return make_autoencoder_steps(kl_weight=case["kl_weight"], ema_decay=0.0)
    if recipe == "classifier":
        return make_classifier_steps(case["class_weights"], ema_decay=0.0)[:2]
    if recipe == "consistency":
        return make_consistency_steps(ConsistencyConfig(), MAX_STEPS)
    if recipe == "ddpm":
        return ddpm.make_ddpm_steps(ddpm.DDPMConfig())
    return make_edm_steps()


def sgd_state(model: torch.nn.Module, ema=None) -> TrainState:
    """A state whose step moves each parameter by minus its gradient (SGD at
    1), so the parameters after a step hold the averaged gradients
    themselves; Adam's first step is blind to their scale."""
    return TrainState(model, torch.optim.SGD([p for p in model.parameters() if p.requires_grad],
                                             lr=1.0), ema=ema)


def adam_state(model: torch.nn.Module) -> TrainState:
    """The EDM recipes' Adam at 1e-4 under the cosine schedule."""
    return TrainState(model, make_optimizer("adam", model, 1e-4),
                      cosine_annealing(1e-4, MAX_STEPS))


def rows(x, sl: slice):
    return {k: v[sl] for k, v in x.items()} if isinstance(x, dict) else x[sl]


def one_step(recipe: str, case: dict, sl: slice, *, jax_draws: bool, model=None, ema=None):
    """One train step of ``recipe`` (SGD at 1) on this rank's rows ``sl`` of
    the case's global batch: the draws from the step's seeded generator, or
    this rank's rows of the JAX step's.  Returns (loss, full parameters
    after it)."""
    model = build_model(case) if model is None else model
    state = sgd_state(model, ema)
    train_step, _ = make_steps(recipe, case)
    batch = {k: torch.from_numpy(v) for k, v in rows(case["batch"], sl).items()}
    if jax_draws:
        metrics = train_step(state, batch, draws={k: torch.from_numpy(v[sl])
                                                  for k, v in case["draws"].items()})
    else:
        metrics = train_step(state, batch, generator=torch.Generator().manual_seed(5))
    params = {n: (p.full_tensor() if hasattr(p, "full_tensor") else p).detach().clone()
              for n, p in state.model.named_parameters()}
    return float(metrics["loss"]), params


def fsdp_case(case: dict, mesh) -> dict:
    """The 1d_edm step through ``shard_with_ema`` over ``mesh``: its loss,
    full parameters and each parameter's placements and local shape."""
    model, ema = shard_with_ema(build_model(case), mesh, min_size=FSDP_MIN_SIZE)
    layout = {n: (tuple(repr(pl) for pl in p.placements), tuple(p.to_local().shape),
                  tuple(p.device_mesh.mesh_dim_names))
              for n, p in model.named_parameters()}
    loss, params = one_step("1d_edm", case, local_batch_slice(len(case["batch"]["signal"])),
                            jax_draws=False, model=model, ema=ema)
    want = {n: tuple(repr(pl) for pl in pls)
            for n, pls in fsdp_shardings(build_model(case), mesh, min_size=FSDP_MIN_SIZE).items()}
    return {"loss": loss, "params": params, "layout": layout, "shardings": want}


def channels_last_case(case: dict, mesh) -> dict:
    """The classifier (2D convolutions) moved to ``channels_last`` as the
    train CLI places models on the card, then sharded: whether every
    parameter keeps its values."""
    model = build_model(case).to(memory_format=torch.channels_last)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    shard_model(model, mesh, min_size=FSDP_MIN_SIZE)
    return {n: torch.equal(p.full_tensor(), before[n]) for n, p in model.named_parameters()}


def loader_checks(h5path: str) -> dict:
    """``local_batch_slice`` and ``BatchLoader`` at 4 ranks: the slices, the
    rows each rank reads, and the refusals of an indivisible batch."""
    out = {"slice": local_batch_slice(8)}
    for bad in (lambda: local_batch_slice(7),
                lambda: next(iter(BatchLoader(_ds(h5path), 7, prefetch=0, device="cpu",
                                              keys=("signal", "cond"))))):
        try:
            bad()
        except ValueError as e:
            out.setdefault("refusals", []).append(str(e))
    ds = _ds(h5path)
    seen = []
    load = ds.load_batch
    ds.load_batch = lambda idx, keys=None: seen.append(np.array(idx)) or load(idx, keys)
    loader = BatchLoader(ds, 8, prefetch=0, device="cpu", keys=("signal", "cond"), seed=3)
    first = next(iter(loader))
    loader.epoch = 0  # the epoch just begun: its global batches
    out |= {"read": seen[0], "first_rows": first["signal"].shape[0],
            "global_first": loader._batch_indices()[0]}
    return out


def _ds(h5path: str, split: str = "train") -> Dataset:
    return Dataset(h5path, Identity(), cut=64, cond=True, split=split)


def fit_case(case: dict, h5path: str, workdir: Path) -> dict:
    """A 4-rank ``Trainer.fit`` of the 1d_edm UNet over the synthetic dataset
    for 2 epochs, then a resume to 3; which ranks saved checkpoints."""
    saves = []
    save = checkpoint.Checkpointer.save

    def spy(self, step, state, metrics=None):
        saves.append(step)
        return save(self, step, state, metrics)

    checkpoint.Checkpointer.save = spy
    keys = ("signal", "cond")
    train = BatchLoader(_ds(h5path), 8, prefetch=0, device="cpu", keys=keys)
    val = BatchLoader(_ds(h5path, "validation"), 4, shuffle=False, drop_last=True,
                      prefetch=0, device="cpu", keys=keys)
    steps = make_edm_steps()
    refusal = None
    try:  # a global batch of 7 over 4 ranks: every rank raises at its first batch
        Trainer(*steps, workdir / "bad", device="cpu", max_epochs=1).fit(
            adam_state(build_model(case)), BatchLoader(_ds(h5path), 7, prefetch=0,
                                                       device="cpu", keys=keys), resume=False)
    except ValueError as e:
        refusal = str(e)
    trainer = Trainer(*steps, workdir, device="cpu", max_epochs=2, log_every=1)
    state = trainer.fit(adam_state(build_model(case)), train, val, resume=False)
    first = state.step
    trainer = Trainer(*steps, workdir, device="cpu", max_epochs=3, log_every=1)
    fresh = build_model(case)
    torch.nn.init.zeros_(next(fresh.parameters()))
    state = trainer.fit(adam_state(fresh), train, val, resume=True)
    checkpoint.Checkpointer.save = save
    return {"steps": (first, state.step), "len": len(train), "saves": saves, "refusal": refusal}


class RowMetric:
    """A metric of whole batches (``SamplingEvalCallback``'s ``metrics``): not
    a mean of per-rank values."""
    name = "row_metric"

    def __call__(self, pred, target):
        return float(np.mean(pred * target) + np.std(pred))


class RankPlot:
    """A plot whose figure writes the rank that saved it."""
    name = "rank plot"

    def __call__(self, pred, target, **kwargs):
        return self

    def savefig(self, path, **kwargs):
        Path(path).write_text(str(rank()))


def stub_sample(model, generator, batch):
    """The callback's ``sample_fn`` without a model: per-row draws scaled by
    each row's first conditioning feature, channels-last (B, T, C)."""
    cond = torch.as_tensor(batch["cond"])
    shape = (len(cond), *batch["waveform"].shape[1:])
    return draw_rows(torch.randn, shape, generator=generator) * (1 + cond[:, :1, None])


def callback_case(batches: list, workdir: Path) -> None:
    """The sampling-eval callback once over this rank's rows of ``batches``
    (global, numpy), its scalars and figures written by rank 0."""
    sl = local_batch_slice(len(batches[0]["cond"]))
    mine = [{k: torch.from_numpy(v[sl]) for k, v in b.items()} for b in batches]
    cb = SamplingEvalCallback(stub_sample, mine, Identity(), metrics=[RowMetric()],
                              plots=[RankPlot()], every_n_epochs=1)
    cb(Trainer(None, None, workdir, device="cpu"), SimpleNamespace(ema=None), 0, 7)


def main(local_rank: int, world: int, port: int, tmp: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=local_rank,
                            world_size=world)
    tmp = Path(tmp)
    inputs = torch.load(tmp / "inputs.pt", weights_only=False)
    out = {"rank": rank(), "world": world_size()}
    for recipe, case in inputs["cases"].items():
        sl = local_batch_slice(len(case["batch"]["signal"]))
        out[recipe] = {"generator": one_step(recipe, case, sl, jax_draws=False),
                       "jax_draws": one_step(recipe, case, sl, jax_draws=True)}
    edm = inputs["cases"]["1d_edm"]
    hybrid = make_hybrid_mesh(2)
    out["hybrid"] = {"shape": tuple(hybrid.shape), "names": hybrid.mesh_dim_names,
                     "coordinate": tuple(hybrid.get_coordinate()),
                     "step": one_step("1d_edm", edm, local_batch_slice(8), jax_draws=False)}
    out["spec_selection"] = {n: tuple(repr(pl) for pl in pls) for n, pls in fsdp_shardings(
        {k: torch.zeros(shape) for k, shape in inputs["spec_tree"].items()}, make_mesh(),
        min_size=2**12).items()}
    out["fsdp"] = fsdp_case(edm, make_mesh())
    out["hsdp"] = fsdp_case(edm, hybrid)
    out["channels_last"] = channels_last_case(inputs["cases"]["classifier"], make_mesh())
    out["loader"] = loader_checks(inputs["h5path"])
    out["fit"] = fit_case(edm, inputs["h5path"], tmp / "fit")
    callback_case(inputs["callback_batches"], tmp / "callback")
    evaluate.main(inputs["evaluate_argv"])
    torch.save(out, tmp / f"rank{rank()}.pt")
    dist.barrier()
    dist.destroy_process_group()
