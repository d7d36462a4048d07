"""The port's data parallelism (``tqdne_tpu_torch/parallel``) against its own
1-rank path and the JAX package, on the CPU over gloo.

One module fixture starts four ranks once (``tests/torch_parallel_worker.py``);
while they run, the test process computes the references: the port's 1-rank
step at the global batch and the JAX step on its 8-virtual-device mesh
(``tests/test_train.py:110``'s invariant), for ``1d_edm``, ``autoencoder``,
``classifier`` (ranks with different label mixes), ``consistency`` and
``ddpm``, one f32 step each at 4 ranks x 2 rows, under SGD at 1 on both sides:
the parameters after the step are then p - g, a check of the averaged
gradients themselves (Adam's first step moves by about the learning rate
whatever the gradient's scale, and by noise where a gradient is zero up to
rounding, as the biases before a one-channel GroupNorm are).  Tolerances as
``tests/test_train.py:110``: the loss to 1e-5 relative, the parameters to
rtol 1e-4 / atol 1e-6.  The ranks also run the hybrid 2 x 2 mesh, FSDP and
HSDP (``tests/test_fsdp.py``, ``tests/test_hybrid_mesh.py``), the loader's
per-rank rows, a 4-rank ``Trainer.fit`` with its resume
(``tests/_multihost_worker.py``) and the evaluate CLI.  One more test drives
the train CLI's ``-d 2`` (its own spawn) against ``-d 1``.  Dropout is 0
throughout: its masks are each rank's own.
"""

import json
import socket
import time
from concurrent.futures import ThreadPoolExecutor

import h5py
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_worker as worker
from test_torch_port_1d import UNET_1D, edm_draws
from test_torch_port_consistency import consistency_draws
from test_torch_port_models import random_params
from test_torch_port_recipes import TINY_CLF
from test_torch_port_train import DEC, ENC, tiny_ae_pair
from tqdne_tpu.diffusion import consistency as jcons
from tqdne_tpu.diffusion import ddpm as jddpm
from tqdne_tpu.models.classifier import Classifier as JaxClassifier
from tqdne_tpu.models.unet import UNet as JaxUNet
from tqdne_tpu.parallel.mesh import batch_sharding, make_mesh
from tqdne_tpu.train import state as jstate
from tqdne_tpu.train import steps as jsteps
from tqdne_tpu_torch import configs
from tqdne_tpu_torch.cli import common
from tqdne_tpu_torch.cli import train as train_cli
from tqdne_tpu_torch.data.dataset import make_synthetic_dataset
from tqdne_tpu_torch.diffusion.consistency import ConsistencyConfig, num_timesteps
from tqdne_tpu_torch.eval.report import read_eval_files
from tqdne_tpu_torch.models.classifier import weighted_cross_entropy
from tqdne_tpu_torch.utils import randomize_
from tqdne_tpu_torch.utils.convert import flax_to_state_dict

WORLD = 4
B = 8  # the global batch: 2 rows a rank
L = 64  # the 1D UNets' signal
RECIPES = ("1d_edm", "autoencoder", "classifier", "consistency", "ddpm")
LOSS_RTOL, RTOL, ATOL = 1e-5, 1e-4, 1e-6
# the classifier's labels: each rank's two rows from other classes, whose weights differ
LABELS = np.array([0, 0, 1, 2, 3, 3, 5, 7], np.int32)
JOIN_TIMEOUT = 600


def _sd(tree) -> dict:
    return flax_to_state_dict(jax.tree_util.tree_map(np.asarray, tree))


def _case(recipe: str, rng):
    """(the ranks' case: port weights, global batch, JAX's global draws;
    the JAX train step, its params and its key)."""
    key = jax.random.key(40 + RECIPES.index(recipe))
    tx = optax.sgd(1.0)
    cond = rng.standard_normal((B, 5)).astype(np.float32)
    if recipe == "autoencoder":
        jm, params, _ = tiny_ae_pair(seed=3)
        batch = {"signal": rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)}
        train_step, _ = jsteps.make_autoencoder_steps(jm, tx, kl_weight=0.1)
        draws = {"ae_eps": np.asarray(jax.random.normal(jax.random.split(key, 3)[0],
                                                        (B, 4, 4, 8)))}
        case = {"model": ("autoencoder", (ENC, DEC)), "kl_weight": 0.1}
    elif recipe == "classifier":
        jm = JaxClassifier(encoder_config=TINY_CLF, num_classes=36)
        params = random_params(jm, jnp.zeros((1, 16, 16, 3)), seed=8)
        weights = rng.uniform(0.5, 2.0, 36).astype(np.float32)
        batch = {"signal": rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32),
                 "label": LABELS}
        train_step = jsteps.make_classifier_steps(jm, tx, weights)[0]
        draws = {}
        case = {"model": ("classifier", (TINY_CLF, 36)), "class_weights": weights}
    else:
        cfg = UNET_1D | {"in_channels": 3, "out_channels": 3}
        jm = JaxUNet(**cfg)
        params = random_params(jm, jnp.zeros((1, L, 3)), jnp.zeros((1,)), jnp.zeros((1, 5)),
                               seed=11 + RECIPES.index(recipe), std=0.05)
        batch = {"signal": rng.uniform(-1, 1, (B, L, 3)).astype(np.float32), "cond": cond}
        shape = batch["signal"].shape
        if recipe == "consistency":
            train_step = jcons.make_consistency_steps(jm, tx, jcons.ConsistencyConfig(),
                                                      worker.MAX_STEPS)[0]
            n = num_timesteps(ConsistencyConfig(), 0, worker.MAX_STEPS)
            draws = consistency_draws(jax.random.split(key, 3)[2], shape, n)
        elif recipe == "ddpm":
            train_step = jddpm.make_ddpm_steps(jm, tx, jddpm.DDPMConfig())[0]
            key_t, key_n = jax.random.split(jax.random.split(key)[1])
            draws = {"t": jax.random.randint(key_t, (B,), 0, 1000),
                     "noise": jax.random.normal(key_n, shape)}
        else:
            train_step = jsteps.make_edm_steps(jm, tx)[0]
            draws = edm_draws(key, shape)
        draws = {k: np.asarray(v) for k, v in draws.items()}
        case = {"model": ("unet", cfg)}
    case |= {"state_dict": _sd(params), "batch": batch, "draws": draws}
    return case, (train_step, params, key, tx)


def _jax_mesh_step(train_step, params, key, tx, batch) -> tuple[float, dict]:
    """The JAX step with the global batch sharded over the 8-device mesh."""
    bshard = batch_sharding(make_mesh())
    state = jstate.TrainState.create(params, tx)
    step = jax.jit(train_step, in_shardings=(None, bshard, None))
    new, metrics = step(state, jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                                              bshard), key)
    return float(metrics["loss"]), _sd(new.params)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _evaluate_setup(tmp_path) -> list[str]:
    """A ``1d_edm`` workdir: a synthetic dataset of 24 rows and seeded weights
    at the ``--tiny`` widths; the evaluate CLI's arguments over all of it."""
    config = configs.MovingAverageEnvelopeConfig(workdir=str(tmp_path / "eval"))
    make_synthetic_dataset(config.datapath, n=24, t=config.t)
    ch = common.signal_shape(config)[-1]
    unet, _ = common.build_unet(config, ch, ch, dims=1, model_channels=common.TINY_CHANNELS)
    torch.save(randomize_(unet, 0).state_dict(), tmp_path / "unet.pt")
    return ["--workdir", str(tmp_path / "eval"), "--config", "1d_edm", "--unet-weights",
            str(tmp_path / "unet.pt"), "--tiny", "--device", "cpu", "--dtype", "f32",
            "--split", "full", "-b", "3", "--num-steps", "2", "--no-classifier"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results, and the references computed while they ran."""
    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    cases, jax_steps = {}, {}
    for recipe in RECIPES:
        cases[recipe], jax_steps[recipe] = _case(recipe, rng)
    h5path = make_synthetic_dataset(tmp / "p.h5", n=160, t=64)
    callback_batches = [{"waveform": rng.standard_normal((B, 32, 3)).astype(np.float32),
                         "cond": rng.standard_normal((B, 5)).astype(np.float32)}
                        for _ in range(2)]
    torch.save({"cases": cases, "h5path": str(h5path), "evaluate_argv": _evaluate_setup(tmp),
                "callback_batches": callback_batches,
                "spec_tree": {"big_kernel": (5, 64, 512), "bias": (512,), "odd": (513, 200),
                              "tiny": (4, 4)}}, tmp / "inputs.pt")

    ctx = torch.multiprocessing.start_processes(
        worker.main, args=(WORLD, _free_port(), str(tmp)), nprocs=WORLD, join=False,
        start_method="spawn")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        refs = {}
        for recipe in RECIPES:
            refs[recipe] = {"port": worker.one_step(recipe, cases[recipe], slice(None),
                                                    jax_draws=False),
                            "jax": _jax_mesh_step(*jax_steps[recipe], cases[recipe]["batch"])}
        deadline = time.monotonic() + JOIN_TIMEOUT
        while not ctx.join(timeout=1):  # True once every rank has exited 0; raises if one fails
            if time.monotonic() > deadline:
                pytest.fail(f"the ranks did not finish in {JOIN_TIMEOUT} s")
    finally:
        torch.set_num_threads(threads)
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    assert not any(p.is_alive() for p in ctx.processes)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"ranks": ranks, "refs": refs, "cases": cases, "tmp": tmp,
            "callback_batches": callback_batches}


def _assert_params(got: dict, want: dict, err: str):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{err}: {name}")


@pytest.mark.parametrize("recipe", RECIPES)
def test_data_parallel_step_matches_one_rank_and_jax(runs, recipe):
    """One f32 step (SGD at 1) at 4 ranks x 2 rows: every rank ends with the same
    parameters (bit for bit); with the step's generator they are the port's
    1-rank step at 8 rows, and with each rank's rows of the JAX step's draws
    the JAX step on the 8-device mesh.  The loss is the ranks' mean."""
    got = [r[recipe] for r in runs["ranks"]]
    for kind, (want_loss, want_params) in (("generator", runs["refs"][recipe]["port"]),
                                           ("jax_draws", runs["refs"][recipe]["jax"])):
        losses = [g[kind][0] for g in got]
        np.testing.assert_allclose(np.mean(losses), want_loss, rtol=LOSS_RTOL, err_msg=kind)
        for g in got[1:]:
            for name, p in g[kind][1].items():
                assert torch.equal(p, got[0][kind][1][name]), (kind, name)
        _assert_params(got[0][kind][1], want_params, kind)


def test_classifier_ranks_hold_different_label_mixes(runs):
    """The classifier's global weighted mean is not the mean of the ranks'
    weighted means for these labels (by far more than the step's tolerance):
    the step above holds the former."""
    case = runs["cases"]["classifier"]
    model = worker.build_model(case).eval()
    weights = torch.from_numpy(case["class_weights"])
    with torch.no_grad():
        logits = model(torch.from_numpy(case["batch"]["signal"]))
    labels = torch.from_numpy(LABELS).long()
    whole = weighted_cross_entropy(logits, labels, weights).item()
    local = np.mean([weighted_cross_entropy(logits[s:s + 2], labels[s:s + 2], weights).item()
                     for s in range(0, B, 2)])
    assert abs(local - whole) > 100 * LOSS_RTOL * abs(whole)


def test_local_batch_slice_and_the_loader_take_each_ranks_rows(runs):
    """Rank r owns rows 2r, 2r + 1 of a batch of 8 and reads only those of the
    epoch's global batch; 7 rows over 4 ranks raise with JAX's message."""
    for r, out in enumerate(runs["ranks"]):
        got = out["loader"]
        assert got["slice"] == slice(2 * r, 2 * r + 2)
        assert len(got["refusals"]) == 2
        assert all("not divisible by the 4 participating hosts" in m for m in got["refusals"])
        assert "Use a batch size divisible by 4." in got["refusals"][1]
        np.testing.assert_array_equal(got["read"], got["global_first"][2 * r:2 * r + 2])
        assert got["first_rows"] == 2


def test_hybrid_mesh_matches_flat_data_parallelism(runs):
    """The 2 x 2 ("replica", "data") mesh groups consecutive ranks, its
    coordinates order the batch as the flat ranks do, and its step equals
    the flat one."""
    for r, out in enumerate(runs["ranks"]):
        hybrid = out["hybrid"]
        assert hybrid["shape"] == (2, 2) and hybrid["names"] == ("replica", "data")
        assert hybrid["coordinate"] == (r // 2, r % 2)
        loss, params = out["1d_edm"]["generator"]
        np.testing.assert_allclose(hybrid["step"][0], loss, rtol=LOSS_RTOL)
        _assert_params(hybrid["step"][1], params, "hybrid")


def test_fsdp_shardings_follow_the_jax_sizes(runs):
    """``test_fsdp_spec_selection``'s tree at min_size 2**12: the two large
    leaves shard (dim 0 here), the bias and the tiny one stay replicated."""
    spec = runs["ranks"][0]["spec_selection"]
    assert spec == {"big_kernel": ("Shard(dim=0)",), "odd": ("Shard(dim=0)",),
                    "bias": ("Replicate()",), "tiny": ("Replicate()",)}


@pytest.mark.parametrize("kind", ["fsdp", "hsdp"])
def test_fsdp_and_hsdp_steps_match_the_replicated_step(runs, kind):
    """The 1d_edm step through ``shard_with_ema`` equals the replicated
    step; its large parameters are DTensors sharded over ``data`` (and on
    the hybrid mesh replicated over ``replica``), nothing sharded across
    ``replica``, as ``fsdp_shardings`` says."""
    for out in runs["ranks"]:
        got = out[kind]
        loss, params = out["1d_edm"]["generator"]
        np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
        _assert_params(got["params"], params, kind)
        shards = 2 if kind == "hsdp" else WORLD  # the size of the "data" axis
        large = [n for n, p in params.items() if p.numel() >= worker.FSDP_MIN_SIZE]
        assert large
        for name, (placements, local, names) in got["layout"].items():
            if kind == "hsdp":
                assert names == ("replica", "data") and placements[0] == "Replicate()"
            else:
                assert names == ("data",)
            assert placements[-1] == "Shard(dim=0)", name  # the root's unit shards too
            assert local[0] <= -(-params[name].shape[0] // shards), name
        for name in large:
            assert got["shardings"][name][-1] == "Shard(dim=0)", name
            assert got["layout"][name][1][0] < params[name].shape[0], name


def test_fsdp_keeps_the_values_of_a_channels_last_model(runs):
    """The classifier moved to ``channels_last`` (as the train CLI places
    models on the card) keeps every parameter's values through FSDP2's
    dim-0 sharding."""
    for out in runs["ranks"]:
        assert out["channels_last"] and all(out["channels_last"].values())


def test_four_rank_trainer_fit_writes_once_and_resumes(runs):
    """One metrics stream with training and validation rows, checkpoints and
    ``progress.json`` from rank 0 alone, and a resume that reaches 3 epochs;
    a global batch of 7 makes every rank's fit raise with JAX's message."""
    workdir = runs["tmp"] / "fit"
    fits = [out["fit"] for out in runs["ranks"]]
    for fit in fits:
        assert "global batch of 7 rows is not divisible by the 4 participating hosts" in (
            fit["refusal"] or "")
    steps_per_epoch = fits[0]["len"]
    for fit in fits:
        assert fit["steps"] == (2 * steps_per_epoch, 3 * steps_per_epoch)
    assert fits[0]["saves"] and not any(fit["saves"] for fit in fits[1:])
    rows = [json.loads(line) for line in (workdir / "metrics.jsonl").read_text().splitlines()]
    train_steps = [r["step"] for r in rows if "training/loss" in r]
    assert train_steps == sorted(set(train_steps)) and len(train_steps) == 3 * steps_per_epoch
    assert sum("validation/loss" in r for r in rows) == 3
    progress = json.loads((workdir / "checkpoints" / "progress.json").read_text())
    assert progress == {"epoch": 3, "step": 3 * steps_per_epoch}
    assert [p.name for p in (workdir / "checkpoints" / "last").iterdir()] == [
        f"{3 * steps_per_epoch}.pt"]


def test_sampling_eval_callback_on_four_ranks_matches_one(runs, tmp_path):
    """The callback over each rank's rows of two validation batches writes,
    from rank 0 alone, the scalars and figures one rank writes over the whole
    batches: the per-row draws are the ranks' rows of one draw, and the
    metric sees the gathered rows."""
    worker.callback_case(runs["callback_batches"], tmp_path)
    rows = {}
    for name, workdir in (("one", tmp_path), ("four", runs["tmp"] / "callback")):
        (row,) = [json.loads(line) for line in (workdir / "metrics.jsonl").open()]
        rows[name] = row
        (figure,) = (workdir / "plots" / "epoch_0").iterdir()
        assert figure.read_text() == "0"
    assert rows["four"] == rows["one"] and rows["one"]["step"] == 7


def test_multi_rank_evaluate_partitions_the_examples(runs):
    """The evaluate CLI at 4 ranks writes one file a rank; rank r holds the
    examples r, r + 4, ..., so together they are the split once, and the
    port's report reads them as one evaluation."""
    outdir = runs["tmp"] / "eval" / "evaluation"
    files = [outdir / f"EDM-MovingAvg-split_full-rank_{r}.h5" for r in range(WORLD)]
    assert sorted(outdir.iterdir()) == sorted(files)
    with h5py.File(runs["tmp"] / "eval" / "data" / "preprocessed_waveforms.h5") as f:
        magnitude = f["magnitude"][:]
    for r, path in enumerate(files):
        with h5py.File(path) as f:
            np.testing.assert_array_equal(f["magnitude"][:], magnitude[r::WORLD])
            assert f["predicted_waveform"].shape == (6, 3, 4064)
    arrays, _ = read_eval_files([str(p) for p in files])
    assert len(arrays["predicted_waveform"]) == 24
    np.testing.assert_array_equal(np.sort(arrays["magnitude"]), np.sort(magnitude))


def test_train_cli_on_two_ranks_matches_one(tmp_path, monkeypatch):
    """``-d 2`` (two local ranks started by the CLI) at the global batch of 4
    ends with the EMA parameters of ``-d 1``; ``-d`` beyond the visible cards
    exits, naming both counts."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the two ranks' torch threads
    args = ["1d_edm", "--tiny", "--device", "cpu", "-b", "4", "--synthetic", "48",
            "--max-steps", "2", "--dtype", "f32", "--dropout", "0"]
    with pytest.raises(SystemExit, match=r"-d 2 asks for 2 devices, but 0 CUDA"):
        train_cli.main([*args[:2], "--workdir", str(tmp_path / "c"), *args[4:], "-d", "2"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:  # -d 2 starts its ranks from a thread while -d 1 runs here
        with ThreadPoolExecutor(1) as pool:
            two = pool.submit(train_cli.main, [*args, "--workdir", str(tmp_path / "d2"), "-d",
                                               "2"])
            train_cli.main([*args, "--workdir", str(tmp_path / "d1"), "-d", "1"])
            two.result(timeout=JOIN_TIMEOUT)
    finally:
        torch.set_num_threads(threads)
    emas = {}
    for n in (1, 2):
        last_dir = tmp_path / f"d{n}" / "outputs" / "EDM-MovingAvg" / "checkpoints" / "last"
        (last,) = last_dir.iterdir()
        assert last.name == "2.pt"
        emas[n] = torch.load(last, weights_only=True)["ema"]
    _assert_params(emas[2], emas[1], "-d 2")
