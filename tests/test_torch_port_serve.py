"""The port's serving path against the JAX package on the CPU: the
micro-batcher on each case of ``tests/test_serve.py`` (fake device
functions), the HTTP layer of both packages on loopback with the same good
and malformed payloads, the serve CLI on a ``--tiny`` CPU bundle, and the
lock around the first build of a CUDA library."""

import base64
import json
import threading
import time
import urllib.error
import urllib.request
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from tqdne_tpu import serving as jserving
from tqdne_tpu_torch import serving
from tqdne_tpu_torch.cli import serve as serve_cli
from tqdne_tpu_torch.cli.common import build_inference
from tqdne_tpu_torch.cli.generate_waveforms import SUMMARY_STATISTICS
from tqdne_tpu_torch.ops import cuda_build
from tqdne_tpu_torch.utils import fold_seed

PACKAGES = {"jax": jserving, "port": serving}


def _echo(t, run_delay=0.0):
    """A device function that echoes each row's first conditioning value into
    its waveform, so routing across chunks and batches is checkable."""

    def run_fn(key, cond):
        if run_delay:
            time.sleep(run_delay)
        out = np.broadcast_to(cond[:, :1, None], (len(cond), 3, t))
        return np.ascontiguousarray(out, np.float32)

    return run_fn


def _batcher(pkg, run_fn, batch_size, t, **kw):
    """Each package's batcher over ``run_fn``: the JAX one also takes its
    host-side inversion (here the identity) and the waveform length."""
    if pkg is jserving:
        return pkg.Microbatcher(run_fn, lambda x: x, batch_size, t, **kw)
    return pkg.Microbatcher(run_fn, batch_size, **kw)


def _fake_batcher(pkg, batch_size=8, t=16, delay_ms=40.0, run_delay=0.0):
    return _batcher(pkg, _echo(t, run_delay), batch_size, t, max_delay_ms=delay_ms)


@contextmanager
def batchers(**kw):
    made = {name: _fake_batcher(pkg, **kw) for name, pkg in PACKAGES.items()}
    try:
        yield made
    finally:
        for b in made.values():
            b.shutdown()


def test_single_request_roundtrip_matches_jax():
    cond = np.arange(3, dtype=np.float32).reshape(3, 1) * np.ones((3, 5), np.float32)
    with batchers() as b:
        out = {name: bb.generate(cond) for name, bb in b.items()}
    assert out["port"].shape == (3, 3, 16)
    assert np.array_equal(out["port"][:, 0, 0], [0.0, 1.0, 2.0])
    assert np.array_equal(out["port"], out["jax"])


def test_large_request_splits_into_batches_as_jax():
    cond = np.arange(10, dtype=np.float32).reshape(10, 1) * np.ones((10, 5), np.float32)
    with batchers(batch_size=4) as b:
        out = {name: bb.generate(cond) for name, bb in b.items()}
        assert b["port"].batches_run == b["jax"].batches_run == 3  # 4 + 4 + 2
        assert b["port"].rows_served == b["jax"].rows_served == 10
    assert np.array_equal(out["port"][:, 0, 0], np.arange(10, dtype=np.float32))
    assert np.array_equal(out["port"], out["jax"])


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_concurrent_requests_coalesce(name):
    # hold the worker busy so both submits are queued before packing starts
    b = _fake_batcher(PACKAGES[name], batch_size=8, delay_ms=200.0, run_delay=0.05)
    b.generate(np.zeros((1, 5), np.float32))  # warm/occupy
    p1 = b.submit(np.full((3, 5), 1.0, np.float32))
    p2 = b.submit(np.full((3, 5), 2.0, np.float32))
    assert p1.done.wait(10) and p2.done.wait(10)
    assert b.batches_run == 2  # warm-up batch + ONE coalesced batch
    assert np.all(p1.out[:, 0, 0] == 1.0) and np.all(p2.out[:, 0, 0] == 2.0)
    b.shutdown()


def test_seeded_requests_run_exclusively_and_deterministically():
    t, seeds, sizes = 16, [], []

    def run_fn(seed, cond):
        seeds.append(seed)
        sizes.append(len(cond))
        noise = np.random.default_rng(seed).standard_normal((len(cond), 3, t))
        return (noise + cond[:, :1, None]).astype(np.float32)

    b = serving.Microbatcher(run_fn, 8, max_delay_ms=100.0)
    cond = np.ones((2, 5), np.float32)
    out1 = b.generate(cond, seed=7)
    out2 = b.generate(cond, seed=7)
    out3 = b.generate(cond, seed=8)
    b.shutdown()
    assert np.array_equal(out1, out2)
    assert not np.array_equal(out1, out3)
    # the jax.random.fold_in(key(seed), offset) of the JAX batcher, padded to the batch
    assert seeds == [fold_seed(7, 0), fold_seed(7, 0), fold_seed(8, 0)] and sizes == [8] * 3


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_pipeline_overlaps_fetch_with_next_dispatch(name):
    """The device owner issues batch N+1 while batch N's (slow) fetch is
    still under way on the finalizer thread."""
    dispatched = []

    def run_fn(key, cond):
        dispatched.append(time.monotonic())
        return np.zeros((len(cond), 3, 8), np.float32)

    def fetch_fn(out):
        time.sleep(0.15)  # a slow device-to-host fetch
        return out

    b = _batcher(PACKAGES[name], run_fn, 4, 8, max_delay_ms=1.0, fetch_fn=fetch_fn)
    p1 = b.submit(np.zeros((4, 5), np.float32))  # full batch -> no window wait
    p2 = b.submit(np.zeros((4, 5), np.float32))
    assert p1.done.wait(10) and p2.done.wait(10)
    assert len(dispatched) == 2
    assert dispatched[1] - dispatched[0] < 0.15
    b.shutdown()


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_error_propagates_to_caller(name):
    def run_fn(key, cond):
        raise RuntimeError("device on fire")

    b = _batcher(PACKAGES[name], run_fn, 4, 16)
    with pytest.raises(RuntimeError, match="device on fire"):
        b.generate(np.zeros((2, 5), np.float32))
    assert b._worker.is_alive()  # the engine survives a failed batch
    b.shutdown()


def test_request_validation_matches_jax():
    with batchers() as b:
        for bad in (np.zeros((0, 5), np.float32), np.zeros((2, 3), np.float32),
                    np.zeros((serving.MAX_REQUEST_ROWS + 1, 5), np.float32)):
            messages = []
            for name in ("jax", "port"):
                with pytest.raises(PACKAGES[name].RequestError) as err:
                    b[name].submit(bad)
                messages.append(str(err.value))
            assert messages[0] == messages[1]


def test_parse_conditions_matches_jax():
    good = [{"hypocentral_distance": 50, "magnitude": 5.5, "vs30": 400,
             "hypocentre_depth": 20, "azimuthal_gap": 100}, [60, 6.0, 300, 10, 90]]
    rows = serving.parse_conditions(good)
    assert rows.shape == (2, 5) and rows[0, 0] == 50 and rows[1, 1] == 6.0
    np.testing.assert_array_equal(rows, jserving.parse_conditions(good))
    assert serving.FEATURES == jserving.FEATURES
    for bad in (None, [], [[1, 2]], [{"magnitude": 5}], "x", [[1, 2, 3, 4, "abc"]],
                [{"hypocentral_distance": None, "magnitude": 5.5, "vs30": 400,
                  "hypocentre_depth": 20, "azimuthal_gap": 100}]):
        messages = []
        for pkg in (jserving, serving):
            with pytest.raises(pkg.RequestError) as err:
                pkg.parse_conditions(bad)
            messages.append(str(err.value))
        assert messages[0] == messages[1], bad


def _request(url, payload=None, raw: bytes | None = None):
    """(status, JSON body) of a GET (no payload) or a POST."""
    data = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@contextmanager
def serving_on_loopback(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()


ROW = {"hypocentral_distance": 50, "magnitude": 5.5, "vs30": 400, "hypocentre_depth": 20,
       "azimuthal_gap": 100}
HTTP_CASES = [
    ("/generate", {"conditions": [ROW, [60, 6.0, 300, 10, 90]]}, None),
    ("/generate", {"conditions": [[60, 6.0, 300, 10, 90]], "seed": 3, "format": "b64"}, None),
    ("/generate", {"conditions": [[60, 6.0, 300, 10, 90]] * 5, "seed": "4"}, None),
    # negative seeds and the ends of the JAX key's signed 64-bit range
    ("/generate", {"conditions": [ROW], "seed": -1}, None),
    ("/generate", {"conditions": [ROW], "seed": "-5"}, None),
    ("/generate", {"conditions": [ROW], "seed": -2**63}, None),
    ("/generate", {"conditions": [ROW], "seed": 2**63 - 1}, None),
    ("/generate", {"conditions": [[1, 2]]}, None),
    ("/generate", {"conditions": [[50, 5.5, 400, 20, 100]], "seed": "not-an-int"}, None),
    ("/generate", {"conditions": [[50, 5.5, 400, 20, "oops"]]}, None),
    ("/generate", {"conditions": [{"magnitude": 5}]}, None),
    ("/generate", {"conditions": []}, None),
    ("/generate", {}, None),
    ("/generate", None, b"{not json"),
    ("/generate", {"conditions": [[0, 0, 0, 0, 0]] * (serving.MAX_REQUEST_ROWS + 1)}, None),
    ("/elsewhere", {"conditions": [ROW]}, None),
    ("/healthz", None, None),
    ("/info", None, None),
    ("/nothing", None, None),
]


def test_http_layer_matches_jax():
    """Both packages' ``make_server`` over echo batchers: the same status
    codes and JSON bodies for every payload, good or malformed."""
    info = {"config": "latent_edm", "features": list(serving.FEATURES)}

    def normalize(c):
        return (c - SUMMARY_STATISTICS[:, 0]) / SUMMARY_STATISTICS[:, 1]

    answers = {}
    with batchers(batch_size=4, delay_ms=1.0) as b:
        for name, pkg in PACKAGES.items():
            server = pkg.make_server(b[name], normalize, info, port=0)
            with serving_on_loopback(server) as base:
                answers[name] = [_request(base + path, payload, raw)
                                 for path, payload, raw in HTTP_CASES]
    codes = [status for status, _ in answers["port"]]
    assert codes == [200] * 7 + [400] * 8 + [404, 200, 200, 404]
    assert answers["port"] == answers["jax"]
    status, body = answers["port"][1]
    wave = np.frombuffer(base64.b64decode(body["waveforms_b64"]), "<f4").reshape(body["shape"])
    np.testing.assert_allclose(wave[:, 0, 0], normalize(np.array([[60, 6.0, 300, 10, 90]]))[:, 0],
                               rtol=1e-6)


def test_seed_outside_the_jax_key_range_is_a_client_error():
    """Seeds past the signed 64-bit range of ``jax.random.key`` fail the JAX
    server while it builds the key (a 500); the port refuses them as a bad
    request, with the range in the message."""
    answers = {}
    with batchers(batch_size=4, delay_ms=1.0) as b:
        for name, pkg in PACKAGES.items():
            server = pkg.make_server(b[name], lambda c: c, {}, port=0)
            with serving_on_loopback(server) as base:
                answers[name] = [_request(base + "/generate", {"conditions": [ROW], "seed": seed})
                                 for seed in (2**63, 2**100, -2**63 - 1)]
    assert all(status != 200 for status, _ in answers["jax"])
    for (status, body), seed in zip(answers["port"], (2**63, 2**100, -2**63 - 1)):
        assert status == 400
        assert body == {"error": f"seed must be a signed 64-bit integer, got {seed}"}


def test_negative_seed_folds_modulo_2_64():
    assert fold_seed(-1, 0) == fold_seed(2**64 - 1, 0) != fold_seed(1, 0)
    assert fold_seed(-2**63, 3) == fold_seed(2**63, 3)
    assert all(0 <= fold_seed(seed, 1) < 2**63 for seed in (-1, -2**63, 0, 2**63 - 1))


def test_serve_cli_answers_like_generate_on_a_tiny_cpu_bundle():
    """The serve CLI's server on a --tiny CPU bundle with seeded random
    weights: /healthz, /info, and seeded rows equal to ``bundle.generate``
    of the same padded batch with the same generator; a repeated seed is
    bit-identical, another seed differs."""
    args = serve_cli.parse_args(["--tiny", "--device", "cpu", "--num-steps", "2", "--solver",
                                 "dpmpp_2m", "--gl-iters", "2", "--dtype", "f32",
                                 "--batch-size", "4", "--port", "0", "--max-delay-ms", "1"])
    server, batcher = serve_cli.build_server(args)
    bundle = build_inference(dtype=torch.float32, num_steps=2, solver="dpmpp_2m", gl_iters=2,
                             device="cpu", tiny=True)
    rows = [[50, 5.5, 400, 20, 100], [120, 6.8, 500, 35, 160], [30, 5.0, 350, 12, 80]]
    try:
        with serving_on_loopback(server) as base:
            status, health = _request(base + "/healthz")
            assert status == 200 and health == {"ok": True, "batches_run": 1, "rows_served": 1}
            status, info = _request(base + "/info")
            assert status == 200 and info["devices"] == ["cpu"] and info["t"] == 4064
            assert info["batch_size"] == 4 and info["channels"] == 3
            replies = [_request(base + "/generate", {"conditions": rows, "seed": seed,
                                                     "format": "b64"})
                       for seed in (11, 11, 12)]
    finally:
        batcher.shutdown()
    waves = []
    for status, body in replies:
        assert status == 200 and body["shape"] == [3, 3, 4064]
        waves.append(np.frombuffer(base64.b64decode(body["waveforms_b64"]), "<f4")
                     .reshape(body["shape"]))
    assert np.array_equal(waves[0], waves[1]) and not np.array_equal(waves[0], waves[2])
    cond = (np.array(rows) - SUMMARY_STATISTICS[:, 0]) / SUMMARY_STATISTICS[:, 1]
    cond = np.concatenate([cond, np.zeros((1, 5))]).astype(np.float32)  # padded to the batch
    want = bundle.generate(torch.from_numpy(cond), generator=torch.Generator().manual_seed(
        fold_seed(11, 0)))[:3].numpy()
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    # another thread may split the CPU's reductions differently: 1e-5 of the peak
    np.testing.assert_allclose(waves[0], want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_sampler_result_does_not_depend_on_packing():
    bundle = build_inference(dtype=torch.float32, num_steps=2, solver="heun", gl_iters=2,
                             device="cpu", tiny=True)
    run = bundle.sampler(4)
    cond = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    one, three = run(5, cond[:1]), run(5, cond)
    assert one.shape == three.shape == (4, 3, 4064) and one.dtype == torch.float32
    np.testing.assert_allclose(one[0].numpy(), three[0].numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="exceed the batch"):
        run(5, np.zeros((5, 5), np.float32))


def test_dataset_feature_stats_match_jax(tmp_path):
    """--stats-from-dataset: the conditioning normalisation read off the dataset."""
    from tqdne_tpu import configs as jconfigs
    from tqdne_tpu.cli.common import dataset_feature_stats as jax_stats
    from tqdne_tpu_torch import configs
    from tqdne_tpu_torch.cli.common import dataset_feature_stats
    from tqdne_tpu_torch.data.dataset import make_synthetic_dataset

    config = configs.LatentSpectrogramConfig(workdir=tmp_path)
    make_synthetic_dataset(config.datapath, n=16, t=512)
    want = jax_stats(jconfigs.LatentSpectrogramConfig(workdir=str(tmp_path)))
    assert want.shape == (5, 2)
    np.testing.assert_array_equal(dataset_feature_stats(config), want)


@pytest.mark.parametrize("argv", [["--solver", "consistency", "--config", "1d_edm"],
                                  ["--solver", "distill"], ["--spatial", "2"], ["--int8"]])
def test_serve_cli_refuses_unported_options(argv):
    """Every JAX serve option is ported, with the JAX routing and refusals:
    ``--solver distill`` takes the flagship's distilled student at 2 evals,
    ``--solver consistency`` refuses an EDM recipe other than the flagship,
    ``--spatial`` serves EDM recipes only (the JAX ``build_inference``'s
    refusal) and ``--int8`` is taken by every recipe."""
    if argv == ["--solver", "distill"]:
        args = serve_cli.parse_args(["--device", "cpu", *argv])
        assert (args.config, args.num_steps) == ("latent_distill", 2)
        return
    if argv[0] == "--solver":
        with pytest.raises(SystemExit, match="consistency-model run"):
            serve_cli.parse_args(["--device", "cpu", *argv])
        return
    args = serve_cli.parse_args(["--device", "cpu", *argv])
    assert (args.spatial, args.int8) == ((2, False) if argv[0] == "--spatial" else (0, True))
    if argv[0] == "--spatial":
        with pytest.raises(SystemExit, match="EDM recipes only"):
            serve_cli.parse_args(["--device", "cpu", "--solver", "distill", *argv])


def test_first_library_build_runs_once_across_threads(monkeypatch):
    """Two threads that load a library for the first time at once run the
    build once and get one library."""
    builds = []

    def build(names):
        builds.append(tuple(names))
        time.sleep(0.2)  # a build long enough for the other thread to arrive
        return {name: f"lib{name}.so" for name in names}

    monkeypatch.setattr(cuda_build, "build", build)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: object())
    cuda_build._load.cache_clear()
    try:
        libs = []
        threads = [threading.Thread(target=lambda: libs.append(cuda_build.load("group_norm")))
                   for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        cuda_build._load.cache_clear()
    assert builds == [("group_norm",)]
    assert len(libs) == 2 and libs[0] is libs[1]
