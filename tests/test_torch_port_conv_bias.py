"""The convolutions' bias epilogue (``ops/conv_bias.py``, ``csrc/conv_bias.cu``).

On the CPU: the plain version against its formula, the launch plan's index arithmetic
emulated over every output shape of the three benchmarked networks, ``_Conv`` with a shift,
a ResBlock and its gradients against the two-add formula it replaces, and the calls one
evaluation makes.  On a card (tests marked ``card``, skipped without one; run them with
``python -m pytest --noconftest -m card tests/test_torch_port_conv_bias.py``, which leaves
out the JAX set-up of ``tests/conftest.py``): the kernel against the plain arithmetic at
every such shape and batch, forward and backward, its refusals and its launch counts.
"""

from __future__ import annotations

import math

import pytest
import torch
import torch.nn.functional as F

from tqdne_tpu_torch.models.autoencoder import Decoder
from tqdne_tpu_torch.models.unet import ResBlock, UNet
from tqdne_tpu_torch.nn import layers
from tqdne_tpu_torch.nn.layers import conv_nd
from tqdne_tpu_torch.nn.quant import int8_scope, quant_conv
from tqdne_tpu_torch.ops.conv_bias import conv_bias_add, conv_bias_add_plain, conv_bias_plan
from tqdne_tpu_torch.utils import randomize_

# the benchmarked networks: the flagship's UNet and decoder, and the 1D UNet
FLAGSHIP_UNET = dict(in_channels=8, out_channels=8, model_channels=128, channel_mult=[1, 2, 4, 4],
                     num_res_blocks=2, attention_resolutions=[8], num_heads=4, dims=2,
                     conv_kernel_size=3, cond_features=5)
UNET_1D = dict(in_channels=6, out_channels=6, model_channels=64, channel_mult=[1, 2, 4, 4],
               num_res_blocks=2, attention_resolutions=[8], num_heads=4, dims=1,
               conv_kernel_size=5, cond_features=5)
DECODER = dict(in_channels=8, out_channels=3, model_channels=64, channel_mult=[1, 2, 4],
               num_res_blocks=2, attention_resolutions=[], dims=2, conv_kernel_size=3)
# each network's convolution outputs (C, *spatial), its batch on the card, its calls a
# forward and how many of them take a shift
PATHS = {
    "flagship_unet": ((1024, 78, 22), [(8, 32, 32), (128, 16, 16), (128, 32, 32), (256, 8, 8),
                                      (256, 16, 16), (256, 32, 32), (512, 4, 4), (512, 8, 8),
                                      (512, 16, 16), (1536, 4, 4)]),
    "unet_1d": ((128, 78, 22), [(6, 4064), (64, 2032), (64, 4064), (128, 1016), (128, 2032),
                                (128, 4064), (256, 508), (256, 1016), (256, 2032), (768, 508)]),
    "decoder": ((1024, 18, 0), [(3, 128, 128), (64, 128, 128), (128, 64, 64), (128, 128, 128),
                                (256, 32, 32), (256, 64, 64)]),
}
PATH_SHAPES = [(name, shape) for name, (_, shapes) in PATHS.items() for shape in shapes]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    """The first CUDA card; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _output(b, shape, dtype, channels_last, device="cpu", seed=0):
    """A (B, C, *spatial) output, channels innermost in memory where ``channels_last``."""
    gen = torch.Generator(device).manual_seed(seed)
    c, *sp = shape
    if channels_last:
        y = torch.randn((b, *sp, c), generator=gen, device=device).to(dtype).movedim(-1, 1)
    else:
        y = torch.randn((b, c, *sp), generator=gen, device=device).to(dtype)
    bias = torch.randn(c, generator=gen, device=device).to(dtype)
    shift = torch.randn(b, c, generator=gen, device=device).to(dtype)
    return y, bias, shift


def _formula(y, bias, shift):
    tail = (1,) * (y.dim() - 2)
    out = y.float() + bias.float().view(-1, *tail)
    if shift is not None:
        out = out + shift.float().view(*shift.shape, *tail)
    return out.to(y.dtype)


def _natural(name):
    return name != "unet_1d"  # 2D outputs are channels-last, 1D ones contiguous


# ---- the plain version and the plan, on the CPU -----------------------------------------------


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,channels_last", [((16, 6, 5), True), ((8, 20), False),
                                                 ((3, 24), True), ((6, 9, 7), False)])
def test_plain_is_the_formula_in_place(shape, channels_last, dtype, shifted):
    y, bias, shift = _output(3, shape, DTYPES[dtype], channels_last)
    shift = shift if shifted else None
    want = _formula(y, bias, shift)
    ptr, stride = y.data_ptr(), y.stride()
    got = conv_bias_add_plain(y, bias, shift)
    assert got is y and y.data_ptr() == ptr and y.stride() == stride
    assert torch.equal(y, want)


def _emulate(plan, y, bias, shift):
    """The kernel's arithmetic over ``y``'s storage under ``plan``, as one sample's run of
    elements: channels innermost, element e lies in vector v = e // vec, which thread
    v % (blocks_x x threads) owns, and that thread adds the channel it computed once from
    its own index; rows, element e lies in row e // S of channel row % C."""
    b, s, c, vec = plan.b, plan.s, plan.c, plan.vec
    sh = torch.zeros(b, c) if shift is None else shift.float()
    e = torch.arange(s * c)
    if plan.layout == 0:
        flat = y.permute(0, *range(2, y.dim()), 1).reshape(b, -1).float()
        thread = (e // vec) % (plan.blocks_x * plan.threads)
        held = (thread * vec + e % vec) % c
        assert torch.equal(held, e % c)  # every element meets the channel its thread holds
        return flat + bias.float()[held] + sh[:, held]
    row = e // s
    return y.reshape(b, -1).float() + bias.float()[row % c] + sh[:, row % c]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,shape", PATH_SHAPES)
def test_plan_covers_every_path_shape(name, shape, dtype):
    """Each output shape of the benchmarked networks, in its layout, gets a plan with
    16-byte vectors where the run divides them, whose threads hold their channels over the
    whole grid-stride loop: the kernel's arithmetic emulated over the plan adds what the
    formula adds."""
    dt = DTYPES[dtype]
    y, bias, shift = _output(2, shape, dt, _natural(name))
    plan = conv_bias_plan(tuple(y.shape), y.stride(), y.element_size())
    assert plan.layout == (0 if _natural(name) else 1)
    assert (plan.b, plan.c, plan.s) == (2, shape[0], math.prod(shape[1:]))
    run = math.prod(shape) if plan.layout == 0 else plan.s
    full = 16 // y.element_size()
    assert plan.vec == full if run % full == 0 else run % plan.vec == 0 and plan.vec < full
    if plan.layout == 0:
        assert plan.blocks_x * plan.threads * plan.vec % plan.c == 0 and plan.blocks_y == 2
    want = _formula(y, bias, shift)
    want = want.permute(0, *range(2, y.dim()), 1) if plan.layout == 0 else want
    assert torch.equal(_emulate(plan, y, bias, shift).to(dt), want.reshape(2, -1))


@pytest.mark.parametrize("shape,stride,esize,want_vec", [
    ((2, 256, 508), (130048, 508, 1), 2, 4),      # a row of 508 in bf16: 8-byte vectors
    ((2, 256, 508), (130048, 508, 1), 4, 4),      # in f32, 16 bytes
    ((2, 6, 4064), (24384, 4064, 1), 2, 8),
    ((2, 3, 4, 4), (48, 1, 12, 3), 2, 8),         # 3 channels innermost: 48 a sample
    ((2, 3, 3, 3), (27, 1, 9, 3), 2, 1),          # 27 a sample: one element
    ((2, 6, 1, 3), (18, 1, 18, 6), 4, 2),         # 18 f32 a sample
    ((2, 64, 8, 8), (4096, 1, 512, 64), 2, 8),    # 64 channels innermost: 16 bytes
    ((2, 5, 6), (30, 6, 1), 4, 2),                # rows of 6 f32: 8 bytes
])
def test_plan_narrows_the_vector(shape, stride, esize, want_vec):
    assert conv_bias_plan(shape, stride, esize).vec == want_vec


@pytest.mark.parametrize("make", [
    lambda y: y.transpose(2, 3),        # spatial axes swapped
    lambda y: y[:, :, ::2],             # every other row
    lambda y: y[:, :4],                 # some channels of a contiguous output
    lambda y: y.flatten(1),             # no spatial axis
])
def test_plan_refuses_other_layouts(make):
    y = make(torch.zeros(2, 8, 6, 5))
    with pytest.raises(ValueError, match="conv_bias_add"):
        conv_bias_plan(tuple(y.shape), y.stride(), 4)


def test_plan_channels_repeat_within_the_grid():
    """Channel counts that share few factors with the block still keep each thread's
    channels fixed: the per-sample grid is rounded up to the channels' period."""
    for c in (3, 5, 6, 7, 96, 192, 1536, 1000):
        for esize in (2, 4):
            plan = conv_bias_plan((4, c, 16, 16), (256 * c, 1, 16 * c, c), esize)
            assert plan.layout == 0 and plan.blocks_x * plan.threads * plan.vec % c == 0


# ---- the layers around it, on the CPU ----------------------------------------------------------


@pytest.mark.parametrize("dims,stride,kernel,channels_last", [
    (2, 1, 3, True), (2, 2, 3, True), (2, 1, 1, False), (1, 1, 5, False), (1, 2, 5, True)])
def test_conv_with_shift_is_conv_plus_shift(dims, stride, kernel, channels_last):
    torch.manual_seed(0)
    conv = randomize_(conv_nd(dims, 6, 10, kernel, stride=stride), 3)
    x = torch.randn(2, 6, *(12,) * dims)
    if channels_last:
        x = x.movedim(1, -1).contiguous().movedim(-1, 1)
    shift = torch.randn(2, 10)
    fn = F.conv1d if dims == 1 else F.conv2d
    want = fn(x, conv.weight, conv.bias, stride, kernel // 2) + shift.view(2, 10, *(1,) * dims)
    torch.testing.assert_close(conv(x, shift=shift), want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(conv(x), fn(x, conv.weight, conv.bias, stride, kernel // 2),
                               rtol=1e-6, atol=1e-6)


def test_int8_route_keeps_its_bias_and_adds_the_shift():
    torch.manual_seed(0)
    conv = randomize_(conv_nd(2, 4, 8, 3), 5)
    x, shift = torch.randn(2, 4, 8, 8), torch.randn(2, 8)
    with int8_scope():
        got = conv(x, shift=shift)
    want = quant_conv(x, conv.weight, conv.bias, conv.stride, conv.padding)
    assert torch.equal(got, want + shift.view(2, 8, 1, 1))


def _two_add_resblock(block, x, emb):
    """A ResBlock as it was: each convolution with cuDNN's bias, then the embedding added."""
    def conv(m, h):
        fn = F.conv1d if isinstance(m, torch.nn.Conv1d) else F.conv2d
        return fn(h, m.weight, m.bias, m.stride, m.padding)

    h = conv(block.in_conv, block.in_norm(x))
    emb_out = block.emb_proj(F.silu(emb)).to(h.dtype)
    h = block.out_norm(h + emb_out.reshape(emb_out.shape + (1,) * (h.ndim - 2)))
    h = conv(block.out_conv, block.dropout(h))
    return (x if block.skip is None else conv(block.skip, x)) + h


@pytest.mark.parametrize("dims,cin,cout", [(2, 64, 64), (2, 32, 64), (1, 32, 64), (1, 64, 64)])
def test_resblock_and_gradients_match_the_two_adds(dims, cin, cout):
    """The output and the gradients of x, the embedding, the convolutions' biases and the
    embedding's projection, each to 1e-6 of its largest entry: sums taken in another order.
    (Two groups a norm at 64 channels: at 32, one channel a group, the norm takes out every
    per-channel addend and their gradients are round-off.)"""
    torch.manual_seed(0)
    block = randomize_(ResBlock(cin, 48, out_channels=cout, kernel_size=3 if dims == 2 else 5,
                                dims=dims), 11)
    x0 = torch.randn(3, cin, *((8, 8) if dims == 2 else (40,)))
    emb0 = torch.randn(3, 48)
    grads = []
    for fn in (block, lambda x, e: _two_add_resblock(block, x, e)):
        block.zero_grad()
        x, emb = x0.clone().requires_grad_(), emb0.clone().requires_grad_()
        out = fn(x, emb)
        (out * torch.linspace(-1, 1, out.numel()).view(out.shape)).sum().backward()
        grads.append((out.detach(), x.grad, emb.grad, block.in_conv.bias.grad.clone(),
                      block.emb_proj.weight.grad.clone(), block.out_conv.bias.grad.clone()))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * want.abs().max().item())


@pytest.mark.parametrize("needs", ["y", "bias", "shift", "all", "all_no_shift"])
def test_autograd_matches_the_formula(needs):
    base, bias0, shift0 = _output(3, (5, 7, 6), torch.float32, True, seed=4)
    shift0 = None if needs == "all_no_shift" else shift0
    results = []
    for add in (conv_bias_add, _formula):
        src = base.clone().requires_grad_(needs in ("y", "all", "all_no_shift"))
        bias = bias0.clone().requires_grad_(needs in ("bias", "all", "all_no_shift"))
        shift = None if shift0 is None else shift0.clone().requires_grad_(needs in ("shift",
                                                                                    "all"))
        out = add(src * 1.0, bias, shift)  # a non-leaf, as a convolution's output is
        (out * torch.linspace(-2, 2, out.numel()).view(out.shape)).sum().backward()
        results.append([out.detach()] + [t.grad for t in (src, bias, shift) if t is not None])
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _build(name, device="cpu", dtype=torch.float32):
    torch.manual_seed(0)
    if name == "decoder":
        model = Decoder(**DECODER)
    else:
        model = UNet(**(FLAGSHIP_UNET if name == "flagship_unet" else UNET_1D))
    model = model.to(device=device, dtype=dtype).eval()
    if name != "unet_1d":
        model = model.to(memory_format=torch.channels_last)
    return model


def _evaluate(name, model, b, device="cpu", dtype=torch.float32):
    gen = torch.Generator(device).manual_seed(1)
    if name == "decoder":
        z = torch.randn(b, 8, 32, 32, generator=gen, device=device, dtype=dtype)
        return model(z.to(memory_format=torch.channels_last))
    shape = (32, 32, 8) if name == "flagship_unet" else (4064, 6)
    x = torch.randn(b, *shape, generator=gen, device=device, dtype=dtype)
    return model(x, torch.rand(b, generator=gen, device=device, dtype=dtype),
                 torch.randn(b, 5, generator=gen, device=device, dtype=dtype))


@pytest.mark.parametrize("name", PATHS)
def test_one_evaluation_adds_every_bias_once(name, monkeypatch):
    """One forward of each benchmarked network: every convolution's bias goes through
    ``conv_bias_add`` once, a ResBlock's first one with the embedding, at the shapes the
    card tests hold."""
    calls = []

    def recorded(y, bias, shift=None):
        calls.append((tuple(y.shape[1:]), shift is not None))
        return conv_bias_add(y, bias, shift)

    monkeypatch.setattr(layers, "conv_bias_add", recorded)
    (_, n, shifted), shapes = PATHS[name]
    with torch.no_grad():
        _evaluate(name, _build(name), 1)
    assert len(calls) == n and sum(s for _, s in calls) == shifted
    assert sorted({shape for shape, _ in calls}) == sorted(shapes)


# ---- the kernel, on a card ----------------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("name,shape", PATH_SHAPES)
def test_kernel_matches_plain(card, name, shape, channels_last, dtype, shifted):
    """Every output shape at its network's batch on the card, in both layouts: bit for bit
    the plain arithmetic, in place."""
    (b, _, _), _ = PATHS[name]
    y, bias, shift = _output(b, shape, DTYPES[dtype], channels_last, card)
    shift = shift if shifted else None
    want = _formula(y, bias, shift)
    launches = conv_bias_add.launches
    got = conv_bias_add(y, bias, shift)
    torch.cuda.synchronize()
    assert got is y and conv_bias_add.launches == launches + 1
    assert torch.equal(y, want)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("name,shape", [("flagship_unet", (128, 32, 32)),
                                        ("flagship_unet", (1536, 4, 4)),
                                        ("decoder", (3, 128, 128)), ("unet_1d", (64, 4064)),
                                        ("unet_1d", (256, 508))])
def test_kernel_backward(card, name, shape, shifted, dtype):
    (b, _, _), _ = PATHS[name]
    base, bias0, shift0 = _output(b, shape, DTYPES[dtype], _natural(name), card, seed=2)
    shift0 = shift0 if shifted else None
    results = []
    for add in (conv_bias_add, _formula):
        src = base.clone().requires_grad_()
        bias = bias0.clone().requires_grad_()
        shift = None if shift0 is None else shift0.clone().requires_grad_()
        out = add(src * 1, bias, shift)
        dy = torch.randn(out.shape, generator=torch.Generator(card).manual_seed(3),
                         device=card).to(out.dtype)
        out.backward(dy)
        results.append([out.detach(), src.grad] + [t.grad.float() for t in (bias, shift)
                                                   if t is not None])
    (out, dx, *sums), (want_out, want_dx, *want_sums) = results
    assert torch.equal(out, want_out) and torch.equal(dx, want_dx)
    for got, want in zip(sums, want_sums):
        # f32 sums of up to 1024 x 16384 terms, each side in its own order, then rounded
        tol = 2**-7 if dtype == "bf16" else 1e-4
        torch.testing.assert_close(got, want, rtol=tol, atol=tol * want.abs().max().item())


@pytest.mark.card
@pytest.mark.parametrize("case", ["transposed", "strided", "dtype", "shift_shape", "device",
                                  "misaligned"])
def test_wrapper_refuses_what_the_kernel_does_not_take(card, case):
    y, bias, shift = _output(2, (8, 6, 5), torch.bfloat16, True, card)
    if case == "misaligned":  # one element past the 16 bytes its 8-element vectors need
        buf = torch.empty(y.numel() + 1, dtype=y.dtype, device=card)[1:]
        y = buf.view(2, 6, 5, 8).movedim(-1, 1).copy_(y)
    elif case == "transposed":
        y = y.transpose(2, 3)
    elif case == "strided":
        y = y[:, :, ::2]
    elif case == "dtype":
        bias = bias.float()
    elif case == "shift_shape":
        shift = shift[:1]
    else:
        bias = bias.cpu()
    with pytest.raises(ValueError, match="conv_bias_add"):
        conv_bias_add(y, bias, shift)


@pytest.mark.card
@pytest.mark.parametrize("name", PATHS)
def test_launches_per_evaluation(card, name):
    (_, n, shifted), _ = PATHS[name]
    model = _build(name, card, torch.bfloat16)
    before = conv_bias_add.launches, conv_bias_add.shifted_launches
    with torch.no_grad():
        out = _evaluate(name, model, 2, card, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert (conv_bias_add.launches - before[0], conv_bias_add.shifted_launches - before[1]) \
        == (n, shifted)
