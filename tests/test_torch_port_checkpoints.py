"""The port's checkpoint tools against the JAX package on the CPU: the
converter of reference Lightning checkpoints (``utils/torch_convert.py``)
for the UNet, the autoencoder and the classifier, the EMA merge, the import
CLI, weight export and ``load_exported`` both ways between the packages, and
the generate, serve and evaluate flags that select weights.

No reference checkpoint is downloaded: ``reference_state_dict`` renames a
port module's seeded random weights to the reference's key layout (the
layout ``tqdne_tpu/utils/torch_convert.py`` reads), written here from the
reference's module structure, independently of either converter.  Widths are
the ``--tiny`` presets (32 channels; the classifier's encoder 16).  Tolerance
against JAX: f32 rtol 1e-4 / atol 1e-5; between the port's weight routes,
bit for bit.
"""

import importlib.util
import json
import math
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch
from flax import serialization
from lightning_layout import lightning_checkpoint, reference_state_dict

import jax
import jax.numpy as jnp

from tqdne_tpu import configs as jconfigs
from tqdne_tpu.cli import common as jax_common
from tqdne_tpu.cli import export_weights as jax_export
from tqdne_tpu.cli import import_checkpoint as jax_import
from tqdne_tpu.models.autoencoder import AutoencoderKL as JaxAutoencoderKL
from tqdne_tpu.models.classifier import Classifier as JaxClassifier
from tqdne_tpu.models.unet import UNet as JaxUNet
from tqdne_tpu.utils import torch_convert as jconvert
from tqdne_tpu_torch import configs
from tqdne_tpu_torch.cli import common, evaluate, export_weights, generate_waveforms, serve
from tqdne_tpu_torch.cli import import_checkpoint as port_import
from tqdne_tpu_torch.data.dataset import make_synthetic_dataset
from tqdne_tpu_torch.models.classifier import Classifier
from tqdne_tpu_torch.models.unet import UNet
from tqdne_tpu_torch.train.checkpoint import Checkpointer
from tqdne_tpu_torch.train.state import TrainState, make_optimizer
from tqdne_tpu_torch.utils import fold_seed, randomize_
from tqdne_tpu_torch.utils import torch_convert as convert
from tqdne_tpu_torch.utils.convert import flax_to_state_dict

RTOL, ATOL = 1e-4, 1e-5
STEP = 1234
ROOT = Path(__file__).resolve().parents[1]
AE_ARTIFACT = ROOT / "weights" / "Autoencoder-32x32x4-LogSpectrogram-ema.msgpack"
@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: the suite runs several test
    processes on the same cores, where a pool of spinning threads per process
    slows the small convolutions here many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models():
    """The three tiny port models: (module, kind, preset config, ckpt prefix)."""
    config = configs.LatentSpectrogramConfig()
    ucfg = configs.get_2d_unet_config(config, 8, 8, model_channels=common.TINY_CHANNELS)
    ae, _, _ = common.build_autoencoder(config, tiny=True)
    clf_config = configs.SpectrogramClassificationConfig()
    enc_cfg = configs.get_classifier_encoder_config(clf_config) | common.TINY_CLASSIFIER
    return {"edm": (UNet(**ucfg), "unet", ucfg),
            "autoencoder": (ae, "autoencoder", None),
            "classifier": (Classifier(enc_cfg, clf_config.num_classes), "classifier", enc_cfg)}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Lightning checkpoints of the three tiny models (seeded live weights
    and a different EMA: at the top level for the UNet and the classifier,
    under ``callbacks`` for the autoencoder, without the frozen Fourier W, as
    an EMA callback keeps trainable parameters only), their live and EMA
    reference state dicts, and the EMA written as the port's ``.pt``."""
    tmp = tmp_path_factory.mktemp("ckpts")
    out = {}
    for seed, (name, (module, kind, cfg)) in enumerate(_models().items()):
        live = reference_state_dict(randomize_(module, 10 + seed), kind)
        ema = reference_state_dict(randomize_(module, 20 + seed), kind)
        ckpt = lightning_checkpoint(live, {k: v for k, v in ema.items() if k != "time_embed.W"},
                                    step=STEP, prefix="unet" if kind == "unet" else "",
                                    in_callbacks=name == "autoencoder")
        torch.save(ckpt, tmp / f"{name}.ckpt")
        if kind == "unet":
            ema["time_embed.W"] = live["time_embed.W"]  # the merge keeps the live W
        pt = tmp / f"{name}-ema.pt"
        torch.save(_convert(name, ema, cfg), pt)
        out[name] = dict(path=tmp / f"{name}.ckpt", live=live, ema=ema, pt=pt, cfg=cfg)
    return out


def _convert(name, sd, cfg):
    if name == "edm":
        return convert.convert_unet(sd, cfg)
    if name == "autoencoder":
        enc_cfg, dec_cfg = configs.get_2d_autoencoder_configs(configs.LatentSpectrogramConfig())
        tiny = {"model_channels": common.TINY_CHANNELS}
        return convert.convert_autoencoder(sd, enc_cfg | tiny, dec_cfg | tiny)
    return convert.convert_classifier(sd, cfg)


def _jax_side(name, sd, cfg, rng):
    """(JAX converted variables, inputs, JAX outputs) in f32."""
    if name == "edm":
        variables = jconvert.convert_unet(sd, cfg)
        x = rng.standard_normal((2, 32, 32, 8)).astype(np.float32)
        t = rng.standard_normal(2).astype(np.float32)
        cond = rng.standard_normal((2, 5)).astype(np.float32)
        out = jax.jit(JaxUNet(**cfg).apply)(variables, jnp.asarray(x), jnp.asarray(t),
                                            jnp.asarray(cond))
        return variables, (x, t, cond), [np.asarray(out)]
    if name == "autoencoder":
        jcfg = jconfigs.LatentSpectrogramConfig()
        enc_cfg, dec_cfg = jconfigs.get_2d_autoencoder_configs(jcfg)
        enc_cfg, dec_cfg = enc_cfg | {"model_channels": 32}, dec_cfg | {"model_channels": 32}
        variables = jconvert.convert_autoencoder(sd, enc_cfg, dec_cfg)
        ae = JaxAutoencoderKL(encoder_config=enc_cfg, decoder_config=dec_cfg)
        x = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
        z = rng.standard_normal((1, 16, 16, 8)).astype(np.float32)
        mean, log_std = jax.jit(lambda v, x: ae.apply(v, x, method="moments"))(
            variables, jnp.asarray(x))
        dec = jax.jit(lambda v, z: ae.apply(v, z, method="decode"))(variables, jnp.asarray(z))
        return variables, (x, z), [np.asarray(mean), np.asarray(log_std), np.asarray(dec)]
    variables = jconvert.convert_classifier(sd, dict(cfg))
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    clf = JaxClassifier(encoder_config=dict(cfg),
                        num_classes=int(sd["output_layer.weight"].shape[0]))
    return variables, (x,), [np.asarray(jax.jit(clf.apply)(variables, jnp.asarray(x)))]


@pytest.mark.parametrize("name", ["edm", "autoencoder", "classifier"])
def test_converter_matches_jax(ckpts, rng, name):
    """A reference-layout state dict through the JAX ``convert_*`` and the JAX
    model's forward, against the port's converter and the port's forward; and
    the flax tree the JAX converter makes is the port's state dict under
    ``utils.convert``'s mapping, array for array."""
    module, _, cfg = _models()[name]
    sd = ckpts[name]["live"]
    variables, inputs, want = _jax_side(name, sd, cfg, rng)
    port_sd = _convert(name, sd, cfg)
    module.load_state_dict(port_sd)  # strict: every name and shape
    flax_sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, variables))
    assert flax_sd.keys() == port_sd.keys()
    for key, value in port_sd.items():
        assert torch.equal(flax_sd[key], value.float()), key
    module.eval()
    with torch.no_grad():
        if name == "edm":
            got = [module(*map(torch.from_numpy, inputs))]
        elif name == "autoencoder":
            got = [*module.moments(torch.from_numpy(inputs[0])),
                   module.decode(torch.from_numpy(inputs[1]))]
        else:
            got = [module(torch.from_numpy(inputs[0]))]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cond_emb_scale", [None, 1.0])
def test_unet_with_a_conditioning_embedding_is_refused(ckpts, cond_emb_scale):
    """A checkpoint with the per-feature conditioning embedding converts when
    the config sets ``cond_emb_scale`` (``cond_embed.W`` carried over, the
    conditioning MLP then as wide as the embedding), and is refused, naming
    the option, when it does not."""
    w = np.arange(16, dtype=np.float32)
    sd = dict(ckpts["edm"]["live"], **{"cond_embed.W": w})
    cfg = dict(ckpts["edm"]["cfg"], cond_emb_scale=cond_emb_scale)
    if cond_emb_scale is None:
        with pytest.raises(ValueError, match="per-feature conditioning embedding.*cond_emb_scale"):
            convert.convert_unet(sd, cfg)
        return
    sd["cond_mlp.0.weight"] = np.zeros((sd["cond_mlp.0.weight"].shape[0], 5 * 32), np.float32)
    got = convert.convert_unet(sd, cfg)
    np.testing.assert_array_equal(got["cond_embed.W"].numpy(), w)
    UNet(**cfg).load_state_dict(got)  # strict: every name and shape


@pytest.mark.parametrize("where", ["top", "callbacks", "absent"])
def test_ema_state_found_at_the_top_level_and_under_callbacks(ckpts, where):
    """``ema_state`` at the top level or inside a callback's state, its keys
    with the ``unet.`` prefix stripped, merged over the live weights: the JAX
    ``_ema_state_dict``'s result; None without one."""
    live = ckpts["edm"]["live"]
    ema = {"unet." + k: v + 0.25 for k, v in live.items() if k != "time_embed.W"}
    ckpt = {"top": {"ema_state": ema}, "callbacks": {"callbacks": {"EMA": {"ema_state": ema}}},
            "absent": {}}[where]
    got = convert.ema_state_dict(ckpt, live, "unet")
    want = jax_import._ema_state_dict(ckpt, live, "unet")
    if where == "absent":
        assert got is None and want is None
        return
    assert got.keys() == want.keys() == live.keys()
    for key in live:
        np.testing.assert_array_equal(np.asarray(got[key]), want[key], err_msg=key)
    np.testing.assert_array_equal(np.asarray(got["input_blocks.0.0.weight"]),
                                  live["input_blocks.0.0.weight"] + 0.25)
    np.testing.assert_array_equal(got["time_embed.W"], live["time_embed.W"])


@pytest.fixture(scope="module")
def imported(ckpts, tmp_path_factory):
    """The three checkpoints imported into one workdir by the port's CLI."""
    wd = tmp_path_factory.mktemp("imported")
    for name in ("edm", "autoencoder", "classifier"):
        port_import.main([name, "--ckpt", str(ckpts[name]["path"]), "--workdir", str(wd),
                          "--tiny"])
    return wd


def _sample(bundle, seed=0):
    gen = torch.Generator().manual_seed(seed)
    cond = torch.from_numpy(np.random.default_rng(seed).standard_normal((2, 5)).astype(np.float32))
    return bundle.generate(cond, generator=gen)


SAMPLER = dict(dtype=torch.float32, num_steps=2, solver="dpmpp_2m", gl_iters=2, device="cpu")


def test_import_samples_bit_for_bit(ckpts, imported):
    """The imported runs, the on-the-fly conversion and the EMA ``.pt`` files
    give the same samples bit for bit; the run holds the step, the live
    weights, the EMA and the hparams, and a resume loads it."""
    ckpt_dir = imported / "outputs" / common.RUN_NAME / "checkpoints"
    restored, step = Checkpointer(ckpt_dir).restore_latest_raw()
    assert step == restored["step"] == STEP
    live = convert.convert_unet(ckpts["edm"]["live"], ckpts["edm"]["cfg"])
    for key, value in live.items():
        assert torch.equal(restored["model"][key], value), key
    hparams = json.loads((ckpt_dir / "hparams.json").read_text())
    assert hparams["unet"]["model_channels"] == 32 and hparams["kind"] == "edm"

    run = common.build_inference(workdir=imported, **SAMPLER)
    fly = common.build_inference(edm_checkpoint=ckpts["edm"]["path"],
                                 autoencoder_checkpoint=ckpts["autoencoder"]["path"],
                                 tiny=True, **SAMPLER)
    pt = common.build_inference(unet_weights=ckpts["edm"]["pt"],
                                ae_weights=ckpts["autoencoder"]["pt"], tiny=True, **SAMPLER)
    want = _sample(pt)
    assert torch.isfinite(want).all() and want.abs().max() > 0
    assert torch.equal(_sample(run), want) and torch.equal(_sample(fly), want)
    assert run.provenance == {"run_name": common.RUN_NAME, "recipe": "latent_edm",
                              "checkpoint_step": STEP}
    assert fly.provenance["torch_checkpoint"] == str(ckpts["edm"]["path"])

    # the classifier run against its EMA .pt, and a resume of the autoencoder run
    clf = evaluate.load_classifier_run(imported, "Classifier-LogSpectrogram",
                                       dtype=torch.float32, device="cpu")
    module, _, _ = _models()["classifier"]
    module.load_state_dict(torch.load(ckpts["classifier"]["pt"]))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 64, 64, 3))
                         .astype(np.float32))
    with torch.no_grad():
        assert torch.equal(clf(x), module.eval()(x))
    ae, _, _ = common.build_autoencoder(configs.LatentSpectrogramConfig(), tiny=True)
    state = TrainState(ae, make_optimizer("adamw", ae, 1e-4, 1e-4))
    assert Checkpointer(imported / "outputs" / common.AE_NAME / "checkpoints") \
        .restore_latest(state) == STEP and state.step == STEP


def test_import_verify_needs_the_reference_package(ckpts, tmp_path):
    if importlib.util.find_spec("tqdne") is not None:
        pytest.skip("the reference package is installed")  # pragma: no cover
    with pytest.raises(SystemExit, match="--verify needs the reference 'tqdne'"):
        port_import.import_checkpoint("autoencoder", ckpts["autoencoder"]["path"], tmp_path,
                                      verify=True, tiny=True)
    assert not (tmp_path / "outputs").exists()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_port_export_loads_in_jax(imported, tmp_path, dtype):
    """The port's artifact of the imported flagship run: the JAX
    ``load_exported`` reads the same arrays, and its bytes are the ones flax
    writes for them; the manifest has the JAX fields.  Sampled through
    ``build_inference(exported_weights=)``: the run's samples (f32) and the
    artifact's provenance."""
    digests = tmp_path / "digests.json"
    wpath = export_weights.export_weights("latent_edm", imported, tmp_path, dtype,
                                          digest_out=digests)
    params, manifest = jax_export.load_exported(str(wpath))
    assert set(manifest) == {"run_name", "recipe", "checkpoint_step", "dtype", "param_count",
                             "sha256", "file", "exported_at", "hparams"}
    assert manifest["checkpoint_step"] == STEP and manifest["dtype"] == dtype
    assert json.loads(digests.read_text())[common.RUN_NAME]["sha256"] == manifest["sha256"]
    assert serialization.to_bytes(params) == wpath.read_bytes()
    ema = Checkpointer(imported / "outputs" / common.RUN_NAME / "checkpoints") \
        .restore_latest_raw()[0]["ema"]
    cast = torch.bfloat16 if dtype == "bf16" else torch.float32
    got = flax_to_state_dict(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), params))
    for key, value in ema.items():
        assert torch.equal(got[key], value.to(cast).float()), key
    assert manifest["param_count"] == sum(np.asarray(a).size
                                          for a in jax.tree_util.tree_leaves(params))

    bundle = common.build_inference(workdir=imported, exported_weights=wpath, **SAMPLER)
    assert bundle.provenance["weights_sha256"] == manifest["sha256"]
    assert bundle.provenance["checkpoint_step"] == STEP
    if dtype == "f32":
        assert torch.equal(_sample(bundle), _sample(common.build_inference(workdir=imported,
                                                                           **SAMPLER)))


def test_jax_exports_load_in_the_port(ckpts, tmp_path):
    """A JAX artifact (the JAX import and export of the same checkpoint) and
    the committed autoencoder artifact through the port's ``load_exported``:
    the JAX loader's arrays and manifest; a changed byte is refused with the
    JAX message."""
    jax_import.import_checkpoint("edm", str(ckpts["edm"]["path"]), str(tmp_path / "jax"),
                                 model_channels=32)
    wpath = jax_export.export_weights("latent_edm", str(tmp_path / "jax"), str(tmp_path / "out"),
                                      dtype="bf16")
    loaded = {}
    for path in (wpath, AE_ARTIFACT):
        got, manifest = export_weights.load_exported(path)
        want, want_manifest = jax_export.load_exported(str(path))
        assert manifest == want_manifest
        want_sd = flax_to_state_dict(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), want))
        got_sd = flax_to_state_dict(got)
        assert got_sd.keys() == want_sd.keys()
        for key in want_sd:
            assert torch.equal(got_sd[key], want_sd[key]), key
        loaded[path] = got_sd
    # the JAX import's EMA is the port converter's EMA
    ema = convert.convert_unet(ckpts["edm"]["ema"], ckpts["edm"]["cfg"])
    for key, value in ema.items():
        assert torch.equal(loaded[wpath][key], value.to(torch.bfloat16).float()), key

    data = bytearray(AE_ARTIFACT.read_bytes())
    data[len(data) // 2] ^= 0xFF
    bad = tmp_path / "tampered-ema.msgpack"
    bad.write_bytes(bytes(data))
    manifest = json.loads(AE_ARTIFACT.with_name(AE_ARTIFACT.stem + ".manifest.json").read_text())
    (tmp_path / "tampered-ema.manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(SystemExit, match="sha256 mismatch") as got_err:
        export_weights.load_exported(bad)
    with pytest.raises(SystemExit, match="sha256 mismatch") as want_err:
        jax_export.load_exported(str(bad))
    assert str(got_err.value) == str(want_err.value)


COND = ["--num_samples", "2", "--hypocentral_distance", "50", "--magnitude", "5.5", "--vs30",
        "400", "--hypocentre_depth", "20", "--azimuthal_gap", "100"]
GEN = ["--device", "cpu", "--dtype", "f32", "--num-steps", "2", "--solver", "dpmpp_2m",
       "--gl-iters", "2", "--batch-size", "2", "--tiny"]


def _waves(path):
    with h5py.File(path) as f:
        return f["waveforms"][:]


def test_generate_flags_select_the_weights(ckpts, imported, tmp_path):
    """generate's ``--edm-checkpoint`` with ``--autoencoder-checkpoint`` (both
    or neither, as the JAX CLI), ``--name`` and ``--ae-name`` (runs imported
    under other names), ``--weights`` and ``--stats-from-dataset``."""
    with pytest.raises(SystemExit, match="either both or none of the torch checkpoints"):
        generate_waveforms.main(["--outfile", str(tmp_path / "x.h5"), "--edm-checkpoint",
                                 str(ckpts["edm"]["path"]), *COND, *GEN])
    outs = {}
    outs["fly"] = tmp_path / "fly.h5"
    generate_waveforms.main(["--outfile", str(outs["fly"]), "--edm-checkpoint",
                             str(ckpts["edm"]["path"]), "--autoencoder-checkpoint",
                             str(ckpts["autoencoder"]["path"]), *COND, *GEN])
    outs["run"] = tmp_path / "run.h5"
    generate_waveforms.main(["--outfile", str(outs["run"]), "--workdir", str(imported),
                             *COND, *GEN])
    wd = tmp_path / "named"
    for kind, name in (("edm", "MyEDM"), ("autoencoder", "MyAE")):
        port_import.import_checkpoint(kind, ckpts[kind]["path"], wd, name=name, tiny=True)
    outs["named"] = tmp_path / "named.h5"
    generate_waveforms.main(["--outfile", str(outs["named"]), "--workdir", str(wd), "--name",
                             "MyEDM", "--ae-name", "MyAE", *COND, *GEN])
    wpath = export_weights.export_weights("latent_edm", imported, tmp_path / "w", "f32")
    outs["weights"] = tmp_path / "weights.h5"
    generate_waveforms.main(["--outfile", str(outs["weights"]), "--workdir", str(imported),
                             "--weights", str(wpath), *COND, *GEN])
    want = _waves(outs["run"])
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    for key, path in outs.items():
        np.testing.assert_array_equal(_waves(path), want, err_msg=key)
    with pytest.raises(SystemExit, match="no checkpoint"):
        generate_waveforms.main(["--outfile", str(tmp_path / "x.h5"), "--workdir", str(wd),
                                 *COND, *GEN])

    make_synthetic_dataset(imported / "data" / "preprocessed_waveforms.h5", n=16, t=4064)
    stats = common.dataset_feature_stats(configs.LatentSpectrogramConfig(workdir=imported))
    np.testing.assert_array_equal(
        stats, jax_common.dataset_feature_stats(jconfigs.LatentSpectrogramConfig(
            workdir=str(imported))))
    out = tmp_path / "stats.h5"
    generate_waveforms.main(["--outfile", str(out), "--workdir", str(imported),
                             "--stats-from-dataset", *COND, *GEN])
    raw = np.array([[50, 5.5, 400, 20, 100]] * 2, np.float64)
    bundle = common.build_inference(workdir=imported, **SAMPLER)
    gen = torch.Generator().manual_seed(0)
    cond = torch.as_tensor((raw - stats[:, 0]) / stats[:, 1], dtype=torch.float32)
    np.testing.assert_array_equal(_waves(out), bundle.generate(cond, generator=gen).numpy())


def test_serve_and_evaluate_take_the_run_names(ckpts, tmp_path):
    """serve's ``--name`` / ``--ae-name`` and evaluate's: runs under other
    names serve and evaluate what the ``.pt`` files give, and the evaluate
    file carries the run's provenance."""
    wd = tmp_path / "named"
    for kind, name in (("edm", "MyEDM"), ("autoencoder", "MyAE")):
        port_import.import_checkpoint(kind, ckpts[kind]["path"], wd, name=name, tiny=True)
    args = serve.parse_args(["--workdir", str(wd), "--name", "MyEDM", "--ae-name", "MyAE",
                             "--tiny", "--device", "cpu", "--dtype", "f32", "--num-steps", "2",
                             "--solver", "dpmpp_2m", "--gl-iters", "2", "--batch-size", "2",
                             "--port", "0"])
    server, batcher = serve.build_server(args)
    try:
        cond = np.random.default_rng(0).standard_normal((2, 5)).astype(np.float32)
        got = batcher.generate(cond, seed=7)
    finally:
        server.server_close()
        batcher.shutdown()
    pt = common.build_inference(unet_weights=ckpts["edm"]["pt"],
                                ae_weights=ckpts["autoencoder"]["pt"], tiny=True, **SAMPLER)
    np.testing.assert_array_equal(got, pt.sampler(2)(fold_seed(7, 0), cond).numpy())

    make_synthetic_dataset(wd / "data" / "preprocessed_waveforms.h5", n=24, t=4064)
    evaluate.main(["--workdir", str(wd), "--name", "MyEDM", "--ae-name", "MyAE", "--tiny",
                   "--device", "cpu", "--dtype", "f32", "--num-steps", "1", "-b", "2",
                   "--limit-batches", "1", "--no-classifier"])
    with h5py.File(wd / "evaluation" / "MyEDM-split_test-rank_0.h5") as f:
        prov = json.loads(f.attrs["provenance"])
        assert f["predicted_waveform"].shape == (2, 3, 4064)
    assert prov["run_name"] == "MyEDM" and prov["checkpoint_step"] == STEP
    assert prov["recipe"] == "latent_edm" and math.isfinite(prov["refine_sigma"])
