"""The ranks of ``tests/test_torch_port_spatial.py``: four processes over gloo
on the CPU, started once by its module fixture.  Each rank reads the cases
the test wrote (``inputs.pt``: weights, global inputs and the JAX step's
global draws), runs the port's spatially partitioned paths on its block and
writes what it got to ``rank<r>.pt``, which the test holds against the
1-rank port and the JAX package.  Imports no JAX."""

from __future__ import annotations

import json
import threading
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from tqdne_tpu_torch.cli import serve
from tqdne_tpu_torch.diffusion import edm, sampler
from tqdne_tpu_torch.models.unet import UNet
from tqdne_tpu_torch.nn.layers import conv_nd
from tqdne_tpu_torch.nn.quant import int8_scope
from tqdne_tpu_torch.ops.group_norm import (
    group_norm_silu_plain,
    group_norm_silu_sharded,
    group_norm_stats_plain,
    merge_group_stats,
)
from tqdne_tpu_torch.parallel import spatial
from tqdne_tpu_torch.train.state import TrainState
from tqdne_tpu_torch.train.steps import make_edm_steps, sample_edm

HALO_CASES = [(1, 1, 1), (1, 3, 1), (1, 3, 2), (1, 5, 1), (2, 1, 1), (2, 3, 1), (2, 3, 2)]


def _sum_over_model(grads: dict, scope) -> dict:
    for g in grads.values():
        dist.all_reduce(g, group=scope.model_group)
    return grads


def mesh_checks() -> dict:
    """The meshes at data 2 x model 2 and at model 4, and the shardings of
    ``tests/test_spatial.py``'s batch."""
    out = {}
    for model in (2, 4):
        mesh = spatial.spatial_mesh(model)
        batch = {"signal": np.zeros((4, 32, 32, 3)), "wave": np.zeros((4, 64, 3)),
                 "cond": np.zeros((4, 5)), "label": np.zeros((4,))}
        out[model] = {"shape": tuple(mesh.shape), "names": tuple(mesh.mesh_dim_names),
                      "coordinate": tuple(mesh.get_coordinate()),
                      "shardings": spatial.batch_shardings(mesh, batch),
                      "shard_shapes": {k: v.shape
                                       for k, v in spatial.shard_batch(mesh, batch).items()}}
    try:
        spatial.spatial_mesh(3)
    except ValueError as e:
        out["refusal"] = str(e)
    return out


def halo_checks(case: dict) -> dict:
    """Each (dims, k, stride) convolution on this rank's rows under the scope of a
    model-4 mesh against the unsharded one: its rows of the output, its rows of the
    input's gradient and the weight and bias gradients summed over the shards."""
    mesh = spatial.spatial_mesh(4)
    out = {}
    for dims, k, stride in HALO_CASES:
        x = torch.from_numpy(case[f"x{dims}"])
        conv = conv_nd(dims, x.shape[1], 6, k, stride=stride)
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(case[f"w{dims}_{k}"]))
            conv.bias.copy_(torch.from_numpy(case["bias"]))
        full = x.clone().requires_grad_(True)
        want = conv(full)
        r = torch.from_numpy(case[f"r{dims}_{k}_{stride}"])
        (want * r).sum().backward()
        want_grads = {"weight": conv.weight.grad.clone(), "bias": conv.bias.grad.clone()}
        conv.zero_grad()
        with spatial.spatial_scope(mesh) as scope:
            rows = x.shape[2] // 4
            mine = x.narrow(2, scope.model_rank * rows, rows).clone().requires_grad_(True)
            got = conv(mine)
            orows = got.shape[2]
            (got * r.narrow(2, scope.model_rank * orows, orows)).sum().backward()
            grads = _sum_over_model({"weight": conv.weight.grad.clone(),
                                     "bias": conv.bias.grad.clone()}, scope)
            conv.zero_grad()
            out[(dims, k, stride)] = {
                "out": (got.detach(), want.detach().narrow(2, scope.model_rank * orows, orows)),
                "x_grad": (mine.grad, full.grad.narrow(2, scope.model_rank * rows, rows)),
                **{name: (grads[name], want_grads[name]) for name in grads}}
    return out


def norm_checks(case: dict) -> dict:
    """The sharded GroupNorm (plain statistics, gather, merge, plain apply) on this
    rank's rows of a model-4 mesh against ``group_norm_silu_plain`` on the whole:
    values, and the gradients of x, scale and bias (the last two summed over the
    shards); and the merged statistics against the whole tensor's."""
    mesh = spatial.spatial_mesh(4)
    x = torch.from_numpy(case["x"])  # (B, H, W, C), far from zero
    scale, bias, r = (torch.from_numpy(case[k]) for k in ("scale", "bias", "r"))
    out = {}
    with spatial.spatial_scope(mesh) as scope:
        rows = x.shape[1] // 4
        sl = slice(scope.model_rank * rows, (scope.model_rank + 1) * rows)
        parts = scope.gather_stats(group_norm_stats_plain(x[:, sl], 8))
        whole = group_norm_stats_plain(x, 8)
        mean, rstd = merge_group_stats(parts)
        out["stats"] = ((mean, rstd), (whole[..., 1], torch.rsqrt(whole[..., 2] / whole[..., 0]
                                                                  + 1e-5)))
        for silu in (True, False):
            params = [t.clone().requires_grad_(True) for t in (scale, bias)]
            full = x.clone().requires_grad_(True)
            want = group_norm_silu_plain(full, *params, 8, 1e-5, silu)
            (want * r).sum().backward()
            want_grads = [full.grad[:, sl], params[0].grad.clone(), params[1].grad.clone()]
            params = [t.clone().requires_grad_(True) for t in (scale, bias)]
            mine = x[:, sl].clone().requires_grad_(True)
            got = group_norm_silu_sharded(mine, *params, 8, 1e-5, silu, scope.gather_stats)
            (got * r[:, sl]).sum().backward()
            grads = _sum_over_model({"scale": params[0].grad, "bias": params[1].grad}, scope)
            out[silu] = {"out": (got.detach(), want.detach()[:, sl]),
                         "x_grad": (mine.grad, want_grads[0]),
                         "scale": (grads["scale"], want_grads[1]),
                         "bias": (grads["bias"], want_grads[2])}
    return out


def sample_check(case: dict) -> dict:
    """``UNET_2D`` sampled for 3 Heun steps at batch 2 on a model-4 mesh from the
    injected float64 noise, and in the int8 mode."""
    unet = UNet(**case["cfg"])
    unet.load_state_dict(case["state_dict"])
    mesh = spatial.spatial_mesh(4)
    out = {}
    for int8 in (False, True):
        with int8_scope(int8):
            out[int8] = sample_edm(unet.eval(), tuple(case["noise"].shape),
                                   torch.from_numpy(case["cond"]), num_steps=3,
                                   noise=torch.from_numpy(case["noise"]), device="cpu",
                                   mesh=mesh)
    cond = torch.from_numpy(case["cond"])  # the sampler itself, with the same network
    out["sampler"] = sampler.sample(
        lambda x, sigma: edm.precondition(edm.EDMConfig(), unet, x, sigma, cond=cond),
        tuple(case["noise"].shape), num_steps=3, noise=torch.from_numpy(case["noise"]),
        device="cpu", mesh=mesh)
    return out


def step_check(case: dict) -> dict:
    """One f32 EDM step (SGD at 1, dropout 0) on a data-2 x model-2 mesh, this rank's
    block of the batch: with the step's generator, and with its block of the JAX
    step's draws.  Returns {kind: (loss, parameters after the step)}."""
    mesh = spatial.spatial_mesh(2)
    train_step, _ = make_edm_steps(mesh=mesh)
    batch = spatial.shard_batch(mesh, {k: torch.from_numpy(v) for k, v in case["batch"].items()})
    out = {}
    for kind in ("generator", "jax_draws"):
        unet = UNet(**case["cfg"])
        unet.load_state_dict(case["state_dict"])
        state = TrainState(unet, torch.optim.SGD(
            [p for p in unet.parameters() if p.requires_grad], lr=1.0))
        if kind == "jax_draws":
            draws = spatial.shard_batch(mesh, {k: torch.from_numpy(v)
                                               for k, v in case["draws"].items()})
            metrics = train_step(state, batch, draws=draws)
        else:
            metrics = train_step(state, batch, generator=torch.Generator().manual_seed(5))
        out[kind] = (float(metrics["loss"]),
                     {n: p.detach().clone() for n, p in state.model.named_parameters()})
    return out


def uneven_check(case: dict) -> dict:
    """A 1D UNet over 88 positions (levels of 88, 44 and 22 rows) on a model-4 mesh:
    the first level splits (22 rows a shard), the second does (11) but not before
    its downsample, the third (22 over 4) does not.  Its rows of the output, and
    the gradients of every parameter summed over the shards, against the
    unsharded UNet on this rank."""
    mesh = spatial.spatial_mesh(4)
    unet = UNet(**case["cfg"])
    unet.load_state_dict(case["state_dict"])
    x, sigma, cond, r = (torch.from_numpy(case[k]) for k in ("x", "sigma", "cond", "r"))
    want = unet(x, sigma, cond)
    (want * r).sum().backward()
    want_grads = {n: p.grad.clone() for n, p in unet.named_parameters() if p.grad is not None}
    unet.zero_grad()
    with spatial.spatial_scope(mesh) as scope:
        rows = x.shape[1] // 4
        sl = slice(scope.model_rank * rows, (scope.model_rank + 1) * rows)
        got = unet(x[:, sl], sigma, cond)
        (got * r[:, sl]).sum().backward()
        grads = _sum_over_model({n: p.grad.clone() for n, p in unet.named_parameters()
                                 if p.grad is not None}, scope)
    return {"out": (got.detach(), want.detach()[:, sl]),
            "grads": {n: (grads[n], want_grads[n]) for n in want_grads}}


def post(port: int, path: str, payload=None) -> tuple[int, dict]:
    """(status, JSON body) of a GET (no payload) or a POST to the loopback server."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def serve_check(case: dict):
    """``serve --spatial 2`` over the 4 ranks (a data-2 x model-2 mesh): rank 0 owns
    the server and posts the case's request to it on loopback; the others follow.
    Returns rank 0's response body (None elsewhere) and the batches each ran."""
    args = serve.parse_args([*case["argv"], "--spatial", "2"])
    bundle = serve.build_bundle(args)
    if dist.get_rank() != 0:
        return {"batches": serve.follow(bundle, args.batch_size)}
    server, batcher = serve.build_server(args, bundle)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        status, body = post(port, "/generate", case["request"])
        info = post(port, "/info")[1]
    finally:
        server.shutdown()
        server.server_close()
        batcher.shutdown()
        serve.stop_followers(args.batch_size)
        thread.join(timeout=30)
    return {"status": status, "body": body, "info": info, "batches": batcher.batches_run}


def main(rank: int, world: int, port: int, tmp: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        inputs = torch.load(Path(tmp) / "inputs.pt", weights_only=False)
        out = {"mesh": mesh_checks(), "halo": halo_checks(inputs["halo"]),
               "norm": norm_checks(inputs["norm"]), "sample": sample_check(inputs["sample"]),
               "step": step_check(inputs["step"]), "uneven": uneven_check(inputs["uneven"]),
               "serve": serve_check(inputs["serve"])}
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()
