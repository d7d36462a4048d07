"""The port's spans (``tqdne_tpu_torch.utils.tracing``) on the CPU: each
appears under a profiler, nested as its layer is, counted once per network
evaluation or step; none enters ``record_function`` with no profiler
running; and ``Trainer(profile_steps=)`` writes a chrome trace that holds the
fit's and the step's spans."""

import json

import pytest
import torch

from tqdne_tpu_torch.cli.common import build_inference
from tqdne_tpu_torch.models.dit import DiT
from tqdne_tpu_torch.models.unet import UNet
from tqdne_tpu_torch.train.loop import Trainer
from tqdne_tpu_torch.train.state import TrainState, apply_updates, make_optimizer
from tqdne_tpu_torch.train.steps import make_edm_steps
from tqdne_tpu_torch.utils import randomize_
from tqdne_tpu_torch.utils.tracing import span

TINY_UNET = dict(in_channels=4, out_channels=4, model_channels=16, num_res_blocks=1,
                 attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2,
                 conv_kernel_size=3, dims=2, cond_features=5)

# each span and the spans it may sit directly inside
PARENTS = {"tq::generate": {None}, "tq::sample": {"tq::generate"},
           "tq::invert": {"tq::generate"}, "tq::denoise": {"tq::sample"},
           "tq::decode": {"tq::sample"}, "tq::conv": {"tq::denoise", "tq::decode"},
           "tq::conv_bias": {"tq::conv"},
           "tq::norm": {"tq::denoise", "tq::decode"}, "tq::group_norm_silu": {"tq::norm"},
           "tq::attention": {"tq::denoise", "tq::decode"},
           "tq::loss": {None}, "tq::backward": {None}, "tq::update": {None},
           "tq::group_norm_silu_backward": {"tq::backward"}, "tq::allreduce": {"tq::update"}}
TINY_DIT = dict(input_size=8, patch_size=2, in_channels=4, out_channels=4, hidden_size=48,
                depth=3, num_heads=2, frequency_embedding_size=16, cond_features=5)


@pytest.fixture(autouse=True)
def one_thread():
    """The suite's workers run side by side: small convolutions slow many
    times over with a thread pool each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def tq_spans(prof) -> list[tuple[str, str | None]]:
    """(span, the innermost ``tq::`` span around it, or None) of every ``tq::`` span."""
    out = []
    for ev in prof.events():
        if ev.name.startswith("tq::"):
            parent = ev.cpu_parent
            while parent is not None and not parent.name.startswith("tq::"):
                parent = parent.cpu_parent
            out.append((ev.name, None if parent is None else parent.name))
    return out


def tiny_train():
    unet = randomize_(UNet(**TINY_UNET), 1)
    state = TrainState(unet, make_optimizer("adam", unet, 1e-3), None)
    train_step, _ = make_edm_steps()
    gen = torch.Generator().manual_seed(0)
    batch = {"signal": torch.randn(2, 4, 4, 4, generator=gen),
             "cond": torch.randn(2, 5, generator=gen)}
    return state, train_step, batch


@pytest.mark.parametrize("recipe,solver,evals", [("latent_edm", "heun", 3),
                                                 ("1d_edm", "dpmpp_2m", 2)])
def test_generate_spans_nest_and_count_the_evaluations(recipe, solver, evals):
    """Heun-2 evaluates the network 2N-1 = 3 times, dpmpp_2m-2 N = 2 times."""
    extra = {"gl_iters": 1} if recipe == "latent_edm" else {}
    bundle = build_inference(recipe, device="cpu", tiny=True, num_steps=2, solver=solver,
                             dtype=torch.float32, **extra)
    noise = torch.randn(1, *bundle.model_shape, generator=torch.Generator().manual_seed(0))
    spans = tq_spans(profiled(lambda: bundle.generate(torch.zeros(1, 5), noise=noise)))
    names = [n for n, _ in spans]
    want = {"tq::generate", "tq::sample", "tq::invert", "tq::denoise", "tq::conv",
            "tq::conv_bias", "tq::norm", "tq::group_norm_silu", "tq::attention"}
    if recipe == "latent_edm":
        want.add("tq::decode")
    assert set(names) == want
    for name, parent in spans:
        assert parent in PARENTS[name], (name, parent)
    assert names.count("tq::generate") == names.count("tq::sample") == 1
    assert names.count("tq::denoise") == evals
    assert names.count("tq::norm") == names.count("tq::group_norm_silu")
    assert names.count("tq::conv") == names.count("tq::conv_bias")  # every bias in the epilogue


def test_train_step_spans_once_a_step():
    state, train_step, batch = tiny_train()
    spans = tq_spans(profiled(lambda: [train_step(state, batch) for _ in range(2)]))
    names = [n for n, _ in spans]
    for name in ("tq::loss", "tq::backward", "tq::update"):
        assert names.count(name) == 2, name
    # the GroupNorm backward keeps the name the benchmark's train.gn_bwd_ms reads
    assert "tq::group_norm_silu_backward" in names
    for name, parent in spans:
        if name in PARENTS and PARENTS[name] != {"tq::denoise", "tq::decode"}:
            assert parent in PARENTS[name], (name, parent)
        else:  # the forward's layers run inside the loss
            assert parent in ("tq::loss", "tq::norm"), (name, parent)


def test_no_profiler_no_record_function(monkeypatch):
    """With no profiler running, a batch and a step enter no ``tq::`` range;
    under one, the same counting catches every span."""
    entered = []

    class Counting(torch.autograd.profiler.record_function):
        def __init__(self, name, args=None):
            entered.append(name)
            super().__init__(name, args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    bundle = build_inference("1d_edm", device="cpu", tiny=True, num_steps=1,
                             dtype=torch.float32)
    state, train_step, batch = tiny_train()

    def work():
        bundle.generate(torch.zeros(1, 5))
        train_step(state, batch)

    work()
    assert not [n for n in entered if n.startswith("tq::")]
    assert span("norm") is span("conv")  # one shared no-op context
    profiled(work)
    assert {"tq::generate", "tq::conv", "tq::loss", "tq::update"} <= set(entered)


def test_trainer_profile_window_writes_the_fit_spans(tmp_path):
    """A 3-step fit with ``profile_steps=(1, 2)`` traces step 1 alone."""
    state, train_step, batch = tiny_train()

    class Loader(list):
        epoch = 0

    trainer = Trainer(train_step, None, tmp_path, device="cpu", max_epochs=1, log_every=1,
                      profile_steps=(1, 2))
    trainer.fit(state, Loader([batch] * 3), resume=False)
    assert state.step == 3
    trace = json.loads((tmp_path / "profile" / "steps_1_2.json").read_text())
    names = [e["name"] for e in trace["traceEvents"] if e.get("cat") == "user_annotation"]
    for name in ("tq::fit.load", "tq::fit.step", "tq::fit.log", "tq::loss", "tq::backward",
                 "tq::update"):
        assert names.count(name) == 1, name


def test_dit_spans_in_every_block():
    """A DiT forward of 3 blocks: each block's attention projections (qkv and
    out) and kernel call, its MLP, its two LayerNorm-modulations and two gated
    residuals; the final layer's modulation once more; ``DiT.forwards`` counts
    the forward."""
    dit = randomize_(DiT(**TINY_DIT), 2)
    x = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(0))
    before = DiT.forwards
    spans = tq_spans(profiled(lambda: dit(x, torch.zeros(2), torch.zeros(2, 5))))
    assert DiT.forwards == before + 1
    names = [n for n, _ in spans]
    depth = TINY_DIT["depth"]
    assert {n: names.count(n) for n in set(names)} == {
        "tq::attention": depth, "tq::attn_proj": 2 * depth, "tq::mlp": depth,
        "tq::modulate": 4 * depth + 1}
    assert all(parent is None for _, parent in spans), spans  # none nests in another


def test_allreduce_span_inside_update():
    """One process: ``apply_updates`` records ``tq::allreduce`` (which issues
    nothing at world size 1) inside ``tq::update``, once a step."""
    state, train_step, batch = tiny_train()
    state.model(batch["signal"], torch.zeros(2), batch["cond"]).square().mean().backward()
    spans = tq_spans(profiled(lambda: apply_updates(state)))
    assert spans.count(("tq::allreduce", "tq::update")) == 1
    assert [n for n, _ in spans] == ["tq::update", "tq::allreduce"]
