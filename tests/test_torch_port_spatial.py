"""The port's spatial partitioning (``tqdne_tpu_torch/parallel/spatial.py``)
against its own 1-rank path and the JAX package, on the CPU over gloo.

One module fixture starts four ranks once (``tests/torch_spatial_worker.py``);
while they run, the test process computes the references: the port's 1-rank
sample and step, the JAX sampler (``tests/test_spatial.py``'s ``UNET_2D``,
3 Heun steps from the same float64 noise) and the JAX step on the whole
batch, and a 1-rank server's reply.  The ranks run, on their blocks of a
``("data", "model")`` mesh: the meshes and shardings of
``tests/test_spatial.py`` at data 2 x model 2 and at model 4; every halo
convolution (1D and 2D, k = 1, 3 and 5, stride 1 and 2) with its gradients;
the sharded GroupNorm's plain entries with their gradients; the sample on
model 4; one f32 EDM step (SGD at 1) on data 2 x model 2; a 1D UNet whose
levels do not all split evenly; ``serve --spatial 2`` over the four ranks.
One more test drives the generate CLI's ``--spatial 2`` (its own two ranks)
against ``--spatial 0``.

Tolerances: the sample to ``tests/test_spatial.py:91``'s rtol 2e-4 / atol
1e-5; the step's loss to 1e-5 relative and its parameters to rtol 1e-4 /
atol 1e-6 (``tests/test_spatial.py:64-67``); a convolution, a GroupNorm and
the uneven UNet, whose shards sum the same products in another order, to f32
rounding: rtol 1e-5 / atol 1e-6 for values (atol 1e-6 of the input's 50 for
the GroupNorm over values near 50, whose f32 mean rounds at about 1e-5 either
way, and rtol 1e-4 / atol 1e-5 for its scale and bias gradients, whose sums
of g x_hat carry that rounding; 1e-5 of the peak for the UNet's output, 1e-4
of each gradient's peak plus 1e-6 of the largest), and rtol 1e-5 / atol 1e-5
for gradients summed over the shards; the int8 sample split four ways to 1e-2
of the peak of one rank's (measured 1.6e-3: codes that round the other way
where the merged statistics differ at f32 rounding).  The served and generated
waveforms
to 1e-4 of their peak: the sampled log-spectrogram's f32 difference (about
4e-6 of its peak) passes through the inversion's exp, at up to e^18 for these
random weights.
"""

import socket
import time

import h5py
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_spatial_worker as worker
from test_spatial import UNET_2D
from test_torch_port_1d import edm_draws, one_torch_thread, sample_both  # noqa: F401
from test_torch_port_models import random_params
from tqdne_tpu.models.unet import UNet as JaxUNet
from tqdne_tpu.train import state as jstate
from tqdne_tpu.train import steps as jsteps
from tqdne_tpu_torch.cli import common
from tqdne_tpu_torch.cli import generate_waveforms
from tqdne_tpu_torch.cli import serve as serve_cli
from tqdne_tpu_torch.models.unet import UNet
from tqdne_tpu_torch.nn.quant import int8_scope
from tqdne_tpu_torch.train.state import TrainState
from tqdne_tpu_torch.train.steps import make_edm_steps, sample_edm
from tqdne_tpu_torch.utils import randomize_
from tqdne_tpu_torch.utils.convert import flax_to_state_dict

WORLD = 4
RTOL, ATOL = 2e-4, 1e-5  # tests/test_spatial.py:91
LOSS_RTOL, P_RTOL, P_ATOL = 1e-5, 1e-4, 1e-6  # tests/test_spatial.py:64-67
F32 = dict(rtol=1e-5, atol=1e-6)
SUMMED = dict(rtol=1e-5, atol=1e-5)
# GroupNorm over values near 50: either f32 mean carries rounding of about 50 x 2^-22 (the whole
# tensor's 1.2e-5 from the float64 mean, the merged shards' 6.3e-6), passed on to the output
NORM = dict(rtol=1e-5, atol=1e-6 * 50)
NORM_GRADS = dict(rtol=1e-4, atol=1e-5)  # the scale's sums of g x_hat carry that rounding (5e-5)
# waveforms: the sampled log-spectrogram's f32 difference (about 4e-6 of its peak) passes through
# the inversion's exp, at up to e^18 for these random weights
WAVES = 1e-4
# int8 split against one rank: the shards' merged GroupNorm statistics round otherwise at 1e-7,
# so some codes round the other way, each a step of amax / 127 that later layers spread
# (measured 1.6e-3 of the peak)
INT8_SPLIT = 1e-2
JOIN_TIMEOUT = 600
# a 1D UNet over 88 positions: levels of 88, 44 and 22 rows, attention at the last two
UNEVEN = dict(in_channels=3, out_channels=3, model_channels=16, num_res_blocks=1,
              attention_resolutions=(2, 4), channel_mult=(1, 2, 4), conv_kernel_size=5, dims=1,
              cond_features=5, num_heads=2)
SERVE_ARGV = ["--tiny", "--device", "cpu", "--num-steps", "2", "--solver", "dpmpp_2m",
              "--gl-iters", "2", "--dtype", "f32", "--batch-size", "4", "--port", "0",
              "--max-delay-ms", "1"]
REQUEST = {"conditions": [[50, 5.5, 400, 20, 100], [120, 6.8, 500, 35, 160],
                          [30, 5.0, 350, 12, 80]], "seed": 11, "format": "b64"}


def _sd(tree) -> dict:
    return flax_to_state_dict(jax.tree_util.tree_map(np.asarray, tree))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _unet_case(cfg: dict, shape, seed: int):
    jm = JaxUNet(**cfg)
    params = random_params(jm, jnp.zeros((1, *shape)), jnp.zeros((1,)), jnp.zeros((1, 5)),
                           seed=seed, std=0.05)
    return jm, params


def _cases(rng) -> tuple[dict, dict]:
    """(the ranks' inputs, what the references need)."""
    f32 = np.float32
    halo = {"x1": rng.standard_normal((2, 4, 32)).astype(f32),
            "x2": rng.standard_normal((2, 4, 16, 8)).astype(f32),
            "bias": rng.standard_normal(6).astype(f32)}
    for dims, k, stride in worker.HALO_CASES:
        halo[f"w{dims}_{k}"] = rng.standard_normal((6, 4, *(k,) * dims)).astype(f32)
        size = (32,) if dims == 1 else (16, 8)
        halo[f"r{dims}_{k}_{stride}"] = rng.standard_normal(
            (2, 6, *(n // stride for n in size))).astype(f32)
    norm = {"x": (50 + rng.standard_normal((2, 16, 4, 16))).astype(f32),
            "scale": rng.uniform(0.5, 1.5, 16).astype(f32),
            "bias": rng.standard_normal(16).astype(f32),
            "r": rng.standard_normal((2, 16, 4, 16)).astype(f32)}
    jm, params = _unet_case(UNET_2D, (32, 32, 3), seed=21)
    sample = {"cfg": UNET_2D, "state_dict": _sd(params), "noise": rng.standard_normal(
        (2, 32, 32, 3)), "cond": rng.standard_normal((2, 5)).astype(f32)}
    key = jax.random.key(2)
    batch = {"signal": rng.standard_normal((4, 32, 32, 3)).astype(f32),
             "cond": rng.standard_normal((4, 5)).astype(f32)}
    step = {"cfg": UNET_2D, "state_dict": sample["state_dict"], "batch": batch,
            "draws": {k: v.numpy() for k, v in edm_draws(key, batch["signal"].shape).items()}}
    ujm, uparams = _unet_case(UNEVEN, (88, 3), seed=22)
    uneven = {"cfg": UNEVEN, "state_dict": _sd(uparams),
              "x": rng.standard_normal((2, 88, 3)).astype(f32),
              "sigma": rng.uniform(-1, 1, 2).astype(f32), "cond": rng.standard_normal(
                  (2, 5)).astype(f32), "r": rng.standard_normal((2, 88, 3)).astype(f32)}
    inputs = {"halo": halo, "norm": norm, "sample": sample, "step": step, "uneven": uneven,
              "serve": {"argv": SERVE_ARGV, "request": REQUEST}}
    return inputs, {"jm": jm, "params": params, "key": key}


def _port_unet(case: dict) -> UNet:
    unet = UNet(**case["cfg"])
    unet.load_state_dict(case["state_dict"])
    return unet


def _port_step(case: dict, kind: str) -> tuple[float, dict]:
    """The port's 1-rank step on the whole batch (SGD at 1)."""
    unet = _port_unet(case)
    state = TrainState(unet, torch.optim.SGD([p for p in unet.parameters() if p.requires_grad],
                                             lr=1.0))
    train_step, _ = make_edm_steps()
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    if kind == "jax_draws":
        metrics = train_step(state, batch, draws={k: torch.from_numpy(v)
                                                  for k, v in case["draws"].items()})
    else:
        metrics = train_step(state, batch, generator=torch.Generator().manual_seed(5))
    return float(metrics["loss"]), {n: p.detach().clone() for n, p in unet.named_parameters()}


def _jax_step(jm, params, key, batch) -> tuple[float, dict]:
    """The JAX EDM step (SGD at 1) on the whole batch, replicated."""
    tx = optax.sgd(1.0)
    train_step = jsteps.make_edm_steps(jm, tx)[0]
    new, metrics = jax.jit(train_step)(jstate.TrainState.create(params, tx),
                                       {k: jnp.asarray(v) for k, v in batch.items()}, key)
    return float(metrics["loss"]), _sd(new.params)


def _served_waves(status: int, body: dict) -> np.ndarray:
    import base64

    assert status == 200, body
    return np.frombuffer(base64.b64decode(body["waveforms_b64"]), "<f4").reshape(body["shape"])


def _one_rank_reply() -> tuple[int, dict]:
    """A 1-rank server's reply to ``REQUEST``, over loopback."""
    import threading

    args = serve_cli.parse_args(SERVE_ARGV)
    server, batcher = serve_cli.build_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        return worker.post(server.server_address[1], "/generate", REQUEST)
    finally:
        server.shutdown()
        server.server_close()
        batcher.shutdown()
        thread.join(timeout=30)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results, and the references computed while they ran."""
    tmp = tmp_path_factory.mktemp("spatial")
    inputs, jax_case = _cases(np.random.default_rng(0))
    torch.save(inputs, tmp / "inputs.pt")
    ctx = torch.multiprocessing.start_processes(
        worker.main, args=(WORLD, _free_port(), str(tmp)), nprocs=WORLD, join=False,
        start_method="spawn")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        s = inputs["sample"]
        one_rank = {}
        for int8 in (False, True):
            with int8_scope(int8):
                one_rank[int8] = sample_edm(_port_unet(s).eval(), s["noise"].shape,
                                            torch.from_numpy(s["cond"]), num_steps=3,
                                            noise=torch.from_numpy(s["noise"]),
                                            device="cpu").numpy()
        refs = {"sample": {
            "port": one_rank[False], "int8": one_rank[True],
            "jax": sample_both(jax_case["jm"], jax_case["params"], _port_unet(s).eval(),
                               s["noise"], s["cond"], "heun")[1]}}
        refs["step"] = {kind: _port_step(inputs["step"], kind)
                        for kind in ("generator", "jax_draws")}
        refs["step"]["jax"] = _jax_step(jax_case["jm"], jax_case["params"], jax_case["key"],
                                        inputs["step"]["batch"])
        refs["serve"] = _one_rank_reply()
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
    return {"ranks": ranks, "refs": refs, "inputs": inputs}


def _close(pair, err: str, **tol):
    got, want = (np.asarray(t) for t in pair)
    assert got.shape == want.shape, err
    np.testing.assert_allclose(got, want, err_msg=err, **tol)


def _peak_close(pair, err: str, share: float = 1e-5):
    got, want = (np.asarray(t) for t in pair)
    assert got.shape == want.shape, err
    np.testing.assert_allclose(got, want, rtol=0, atol=share * np.abs(want).max(), err_msg=err)


@pytest.mark.parametrize("model", [2, 4])
def test_spatial_mesh_and_shardings(runs, model):
    """``tests/test_spatial.py:37-45``'s shardings on the data x model mesh; each
    rank's block of the batch; a model that does not divide the world refused."""
    for r, out in enumerate(runs["ranks"]):
        got = out["mesh"][model]
        assert got["shape"] == (WORLD // model, model) and got["names"] == ("data", "model")
        assert got["coordinate"] == (r // model, r % model)
        assert got["shardings"] == {"signal": ("data", "model"), "wave": ("data", "model"),
                                    "cond": ("data",), "label": ("data",)}
        rows = 4 * model // WORLD
        assert got["shard_shapes"] == {"signal": (rows, 32 // model, 32, 3),
                                       "wave": (rows, 64 // model, 3), "cond": (rows, 5),
                                       "label": (rows,)}
        assert out["mesh"]["refusal"] == "4 devices not divisible by model=3"


@pytest.mark.parametrize("case", worker.HALO_CASES, ids=lambda c: "dims{}-k{}-stride{}".format(*c))
def test_halo_convolution_matches_the_unsharded_one(runs, case):
    """Each rank's rows of a convolution under the scope (its halo rows from the
    neighbouring shards, zeros at the edges) and of the input's gradient equal the
    unsharded convolution's; the weight and bias gradients summed over the shards
    equal the unsharded ones."""
    for r, out in enumerate(runs["ranks"]):
        got = out["halo"][case]
        _close(got["out"], f"rank {r} out", **F32)
        _close(got["x_grad"], f"rank {r} x grad", **F32)
        for name in ("weight", "bias"):
            _close(got[name], f"rank {r} {name} grad", **SUMMED)


@pytest.mark.parametrize("silu", [True, False])
def test_sharded_group_norm_matches_the_whole(runs, silu):
    """The shards' statistics merged by Chan's formula are the whole tensor's (mean
    about 50, spread about 1, where a one-pass E[x^2] - mean^2 loses digits); the
    sharded GroupNorm's rows, its x gradient and its scale and bias gradients summed
    over the shards are ``group_norm_silu_plain``'s on the whole tensor."""
    for r, out in enumerate(runs["ranks"]):
        got = out["norm"]
        for a, b, name in zip(*got["stats"], ("mean", "rstd")):
            _close((a, b), f"rank {r} {name}", rtol=1e-6, atol=0)
        for name in ("out", "x_grad"):
            _close(got[silu][name], f"rank {r} {name}", **NORM)
        for name in ("scale", "bias"):
            _close(got[silu][name], f"rank {r} {name} grad", **NORM_GRADS)


def test_spatial_sampling_matches_one_rank_and_jax(runs):
    """``UNET_2D`` sampled for 3 Heun steps at batch 2 split over a model-4 mesh, from
    the same injected float64 noise: every rank's gathered sample is the port's
    1-rank sample and the JAX sampler's, to ``tests/test_spatial.py:91``'s
    tolerance."""
    refs = runs["refs"]["sample"]
    for r, out in enumerate(runs["ranks"]):
        got = out["sample"][False].numpy()
        assert got.shape == (2, 32, 32, 3) and np.isfinite(got).all()
        np.testing.assert_allclose(got, refs["port"], rtol=RTOL, atol=ATOL, err_msg=f"port {r}")
        np.testing.assert_allclose(got, refs["jax"], rtol=RTOL, atol=ATOL, err_msg=f"jax {r}")
        # diffusion.sampler.sample over the mesh: the same sample (sample_edm runs it)
        assert torch.equal(out["sample"]["sampler"].float(), out["sample"][False])


def test_spatial_int8_sampling_matches_one_rank(runs):
    """``--spatial`` and ``--int8`` combine: each activation's amax is taken over every
    rank's block (the JAX amax is over the global array), so the split sample's codes
    are one rank's but where an input differs at f32 rounding, and its result is one
    rank's int8 sample to within the codes that round the other way (each a step of
    amax / 127 at its layer): ``INT8_SPLIT`` of the peak."""
    want = runs["refs"]["sample"]["int8"]
    assert not np.allclose(want, runs["refs"]["sample"]["port"], rtol=RTOL, atol=ATOL)
    for r, out in enumerate(runs["ranks"]):
        got = out["sample"][True].numpy()
        assert np.isfinite(got).all()
        _peak_close((got, want), f"int8 rank {r}", INT8_SPLIT)


def test_spatial_train_step_matches_one_rank_and_jax(runs):
    """One f32 EDM step (SGD at 1) on a data-2 x model-2 mesh: every rank ends with the
    same parameters; with the step's generator (draws at the global shape, cut to
    the rank's block) they are the port's 1-rank step's, with each rank's block of
    the JAX step's draws the replicated JAX step's.  Each rank's loss is its data
    rank's mean; their mean is the global mean loss."""
    refs = runs["refs"]["step"]
    for kind, want in (("generator", refs["generator"]), ("jax_draws", refs["jax_draws"]),
                       ("jax_draws", refs["jax"])):
        got = [out["step"][kind] for out in runs["ranks"]]
        np.testing.assert_allclose(np.mean([g[0] for g in got]), want[0], rtol=LOSS_RTOL,
                                   err_msg=kind)
        for g in got[1:]:
            for name, p in g[1].items():
                assert torch.equal(p, got[0][1][name]), (kind, name)
        assert got[0][1].keys() == want[1].keys()
        for name, p in want[1].items():
            np.testing.assert_allclose(got[0][1][name].numpy(), p.numpy(), rtol=P_RTOL,
                                       atol=P_ATOL, err_msg=f"{kind}: {name}")


def test_uneven_extents_run_gathered(runs):
    """A 1D UNet whose second level (44 rows, 11 a shard) cannot split before its
    stride-2 downsample and whose third (22 rows) does not split over 4 shards
    runs those parts gathered: each rank's rows of the output, and every parameter
    gradient summed over the shards, are the unsharded UNet's."""
    for r, out in enumerate(runs["ranks"]):
        got = out["uneven"]
        _peak_close(got["out"], f"rank {r} out")
        assert len(got["grads"]) > 40
        largest = max(np.abs(np.asarray(want)).max() for _, want in got["grads"].values())
        for name, (g, want) in got["grads"].items():
            # 1e-4 of each gradient's peak, plus 1e-6 of the largest for those zero up to
            # rounding (a bias before a GroupNorm, which shifts its groups alike)
            np.testing.assert_allclose(np.asarray(g), np.asarray(want), rtol=0,
                                       atol=1e-4 * np.abs(np.asarray(want)).max()
                                       + 1e-6 * largest, err_msg=f"rank {r} grad {name}")


def test_serve_spatial_returns_the_one_rank_rows(runs):
    """``serve --spatial 2`` over four ranks (data 2 x model 2): rank 0's server
    answers a seeded request with the rows a 1-rank server returns, reports
    ``spatial``, and every follower ran the warm-up and the request's batch."""
    want = _served_waves(*runs["refs"]["serve"])
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    lead = runs["ranks"][0]["serve"]
    got = _served_waves(lead["status"], lead["body"])
    _peak_close((got, want), "served rows", WAVES)
    assert lead["info"]["spatial"] == 2 and lead["info"]["int8"] is False
    assert lead["batches"] == 2
    assert [out["serve"]["batches"] for out in runs["ranks"][1:]] == [2, 2, 2]


def test_generate_cli_spatial_matches_one_rank(tmp_path):
    """``generate --spatial 2`` (two ranks the CLI starts, gloo on the CPU) writes the
    waveforms ``--spatial 0`` writes, from the same weights files and seed."""
    bundle = common.build_inference(dtype=torch.float32, device="cpu", tiny=True)
    torch.save(randomize_(bundle.unet, 0).state_dict(), tmp_path / "unet.pt")
    torch.save(randomize_(bundle.autoencoder, 1).state_dict(), tmp_path / "ae.pt")
    argv = ["--tiny", "--device", "cpu", "--dtype", "f32", "--num-steps", "2", "--solver",
            "dpmpp_2m", "--gl-iters", "2", "--unet-weights", str(tmp_path / "unet.pt"),
            "--ae-weights", str(tmp_path / "ae.pt"), "--hypocentral_distance", "50",
            "--magnitude", "5.5", "--vs30", "400", "--hypocentre_depth", "20",
            "--azimuthal_gap", "100", "--num_samples", "3", "--batch_size", "2"]
    waves = {}
    for k in (0, 2):
        out = tmp_path / f"spatial{k}.h5"
        generate_waveforms.main([*argv, "--outfile", str(out), "--spatial", str(k)])
        with h5py.File(out, "r") as f:
            waves[k] = f["waveforms"][:]
    assert waves[0].shape == (3, 3, 4064) and np.isfinite(waves[0]).all()
    _peak_close((waves[2], waves[0]), "generated waveforms", WAVES)
    with pytest.raises(SystemExit, match="EDM recipes only"):
        generate_waveforms.main([*argv, "--outfile", str(tmp_path / "x.h5"), "--spatial", "2",
                                 "--config", "ddpm"])
