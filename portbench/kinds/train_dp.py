"""Data-parallel training as the train CLI runs it on N cards (torchrun's
launch: one rank a card, NCCL): each rank holds its own rows of every global
batch, the recipe's ``train_step`` averages the gradients over the ranks
(``parallel.all_reduce_gradients_`` in ``apply_updates``), and every rank
applies the same Adam update and EMA.  The rank's state and step are
``kinds/train.py``'s (through ``registry.kind("train")``): the UNet from the
seed, Adam under the cosine schedule, the EMA, a ``DeviceResidentLoader``,
here over the rank's quarter (its share) of the synthetic set.

This process spawns the cell's ``chips`` ranks (``python kinds/train_dp.py
<spec>``, with the environment torchrun sets and a free loopback port), waits
for them and reports rank 0's result.  A rank that fails ends the others at
once; set-up, every collective and the whole run have time limits, so a run
fails, and never hangs.

Traffic keys: ``batch`` (a rank's), ``dataset_rows`` (all ranks'),
``checked_steps``, ``reference_block``, ``trace_steps``.

Each rank seeds step ``n``'s generator from ``(seed, n)`` (sigma and noise,
drawn at the global batch and cut to the rank's rows, ``parallel.draw_rows``)
and its default generator, the dropout's, from ``(seed, n, rank)``.  The
window starts on every rank at one barrier; rank 0 decides when it ends
(each step it tells the others, over a host group, whether to go on), so it
ends on a whole step of every rank.  ``train_samples_per_s`` counts the
samples of all ranks; the memory peak is the fullest card's.

Correctness (rank 0): the reference (float32, ``kinds/train.py``'s network
and update) follows the checked steps on the whole global batch, with every
rank's rows, draws and dropout masks: ``loss_gap`` (the global mean loss),
``grad_gap``, ``change_gap``, ``ema_gap`` as ``train`` defines them; and
``rank_gap``, the largest difference of any parameter or EMA entry between a
rank and rank 0 after the checked steps (data parallelism keeps the replicas
equal bit for bit).  Faults: ``half_batch`` (each rank trains on half its
rows), ``rank_dies`` (the last rank exits before its first step).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
SETUP_S = 600.0  # what a run may take beyond its window: spawn, build, reference
COLLECTIVE_S = 300  # the process group's timeout on set-up and on every collective


def run(cell, ctx):
    """Spawn the ranks, wait for them, return rank 0's ``Result``."""
    from portbench.harness.context import since_process_start

    world = cell.chips
    if ctx.device.type == "cuda" and torch.cuda.device_count() < world:
        raise SystemExit(f"{cell.name} needs {world} cards; {torch.cuda.device_count()} visible")
    with socket.socket() as s:  # a free port for the ranks' rendezvous
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        spec, out = Path(tmp) / "spec.pt", Path(tmp) / "result.pt"
        torch.save({"cell": {k: getattr(cell, k) for k in ("name", "config", "traffic", "limits",
                                                            "chips")} | {
                                 "bench_dir": str(cell.bench_dir)},
                    "ctx": {"device": ctx.device.type, "seed": ctx.seed, "seconds": ctx.seconds,
                            "trace": ctx.trace, "control": ctx.control, "fault": ctx.fault},
                    "out": str(out)}, spec)
        env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port),
                   PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
        procs = [subprocess.Popen([sys.executable, __file__, str(spec)], cwd=ROOT,
                                  env=env | {"RANK": str(r), "LOCAL_RANK": str(r)})
                 for r in range(world)]
        try:
            _wait(procs, ctx.seconds + SETUP_S)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        done = torch.load(out, weights_only=False)
    ctx.setup_s = since_process_start() - (time.time() - done.pop("opened"))
    ctx.memory_peak_bytes = done.pop("memory_peak_bytes")
    return done["result"]


def _wait(procs, limit_s: float) -> None:
    """Wait for every rank to exit 0; SystemExit at the first that fails or
    when ``limit_s`` has passed."""
    deadline = time.monotonic() + limit_s
    while True:
        codes = [p.poll() for p in procs]
        failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
        if failed:
            raise SystemExit(f"rank {failed[0][0]} exited with {failed[0][1]}; the others ended")
        if all(c == 0 for c in codes):
            return
        if time.monotonic() > deadline:
            raise SystemExit(f"the ranks ran past {limit_s:.0f} s; ended")
        time.sleep(0.2)


def seed_step(ctx, generator: torch.Generator, n: int, rank: int) -> None:
    """Step ``n``'s draws on ``rank``: the shared generator (sigma, noise) and
    the rank's default one (dropout)."""
    from portbench.harness import inputs

    tk = _train()
    generator.manual_seed(inputs.sub_seed(ctx.seed, tk.STREAM_STEP, n, 0))
    torch.manual_seed(inputs.sub_seed(ctx.seed, tk.STREAM_STEP, n, 1, rank))


def _train():
    from portbench.harness import registry

    return registry.kind("train")


def max_steps(cell) -> int:
    """The cosine horizon: the configuration's epochs over the global batches."""
    tr = cell.traffic
    return cell.config["train"]["epochs"] * (tr["dataset_rows"] // (tr["batch"] * cell.chips))


def shard(cell, rank: int) -> slice:
    per = cell.traffic["dataset_rows"] // cell.chips
    return slice(rank * per, (rank + 1) * per)


def build(cell, ctx, rank: int):
    """(state, train_step, loader) of ``rank`` as the train CLI assembles them."""
    from tqdne_tpu_torch.cli import common
    from tqdne_tpu_torch.data.pipeline import DeviceResidentLoader
    from tqdne_tpu_torch.parallel import replicate_
    from tqdne_tpu_torch.train.state import TrainState, cosine_annealing, make_optimizer
    from tqdne_tpu_torch.train.steps import make_edm_steps

    from portbench.harness import inputs

    tk = _train()
    cfg, tr, tcfg = cell.config, cell.traffic, cell.config["train"]
    recipe = common.RECIPES[cfg["recipe"]]
    config = recipe.config_cls(workdir=".")
    channels = cfg["model_shape"][-1]
    tiny = {"model_channels": cfg["unet"]["model_channels"]} if cfg.get("tiny") else {}
    with torch.device("meta"):
        unet, _ = common.build_unet(config, channels, channels, tk.DTYPES[cfg["dtype"]],
                                    dims=recipe.dims, **tiny)
    unet = unet.to_empty(device=ctx.device)
    inputs.load_weights(tk.weights(cell, ctx), [unet])
    replicate_(unet)  # every rank starts from rank 0's weights, as the train CLI
    if ctx.device.type == "cuda":
        unet = unet.to(memory_format=torch.channels_last)
    optimizer = make_optimizer(tcfg["optimizer"], unet, tcfg["learning_rate"])
    state = TrainState(unet, optimizer, cosine_annealing(tcfg["learning_rate"], max_steps(cell)))
    train_step, _ = make_edm_steps(ema_decay=tcfg["ema_decay"])
    waves, cond = tk.data(cell, ctx)
    mine = shard(cell, rank)
    signal = config.make_representation().get_representation(waves[mine])
    rows = tk.Rows({"signal": signal.cpu().numpy(), "cond": cond[mine].cpu().numpy()})
    del waves, cond, signal
    loader = DeviceResidentLoader(rows, tr["batch"], keys=("signal", "cond"),
                                  seed=tk.loader_seed(ctx), device=ctx.device)
    return state, train_step, loader


def rank_main(spec_path: str) -> None:
    """One rank: join the group, train, and on rank 0 check and write the result."""
    import torch.distributed as dist

    with contextlib.suppress(OSError, AttributeError):  # end with the spawning process
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    spec = torch.load(spec_path, weights_only=False)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    sys.path.insert(0, str(ROOT))
    from portbench.harness.context import Ctx
    from portbench.harness.registry import Cell

    c = spec["cell"]
    cell = Cell(c["name"], c["config"], c["traffic"], c["limits"], [], [], c["chips"],
                Path(c["bench_dir"]))
    cuda = spec["ctx"].pop("device") == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    ctx = Ctx(device=device, **spec["ctx"])
    if not cuda:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    timeout = timedelta(seconds=COLLECTIVE_S)
    dist.init_process_group("nccl" if cuda else "gloo", init_method="env://", timeout=timeout)
    host = dist.new_group(backend="gloo", timeout=timeout)
    try:
        out = _train_rank(cell, ctx, rank, world, host)
        if rank == 0:
            torch.save(out, spec["out"])
    finally:
        dist.destroy_process_group()


def _train_rank(cell, ctx, rank: int, world: int, host) -> dict | None:
    import torch.distributed as dist
    from tqdne_tpu_torch.nn.layers import Norm32

    from portbench.harness import flops, trace
    from portbench.harness.context import Result

    tk = _train()
    tr = cell.traffic
    state, train_step, loader = build(cell, ctx, rank)
    names = {p: n for n, p in state.model.named_parameters()}
    gen = torch.Generator(device=ctx.device)
    feed = tk.batches(loader)
    bad = torch.zeros((), device=ctx.device)

    def step(n: int):
        nonlocal bad
        batch = next(feed)
        seed_step(ctx, gen, n, rank)
        if ctx.fault == "half_batch":
            batch = {k: v[: len(v) // 2] for k, v in batch.items()}
        loss = train_step(state, batch, generator=gen)["loss"]
        bad += (~torch.isfinite(loss)).float() * tr["batch"]
        return loss

    if ctx.fault == "rank_dies" and rank == world - 1:  # the others wait in the first step
        os._exit(3)
    theta0 = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    losses = [step(0)]
    grad = {names[p]: float(s["exp_avg"].norm() / (1 - tk.ADAM_B1))
            for p, s in state.optimizer.state.items()}
    for n in range(1, tr["checked_steps"]):
        losses.append(step(n))
    for loss in losses:  # the global batch's mean loss
        dist.all_reduce(loss)
        loss.div_(world)
    ema = dict(state.ema.named_parameters())
    program = {"losses": [float(x) for x in losses], "grad": grad,
               "delta": {n: p.detach() - theta0[n] for n, p in state.model.named_parameters()},
               "ema_delta": {n: ema[n] - theta0[n] for n in theta0}}
    rank_gap = _rank_gap([*state.model.parameters(), *state.ema.parameters()])
    del theta0, ema
    res = Result(unit_size=tr["batch"] * world)
    first = tr["checked_steps"]
    ctx.synchronize()
    dist.barrier(group=host)
    opened = time.time()
    if not ctx.trace:
        t0, n, pending = time.perf_counter(), 0, None
        flag = torch.zeros(1, dtype=torch.int32)
        while True:
            step(first + n)
            n += 1
            pending = tk._wait_previous(ctx, pending)
            flag.fill_(int(rank == 0 and time.perf_counter() - t0 >= ctx.seconds))
            dist.broadcast(flag, 0, group=host)
            if flag.item():
                break
        ctx.synchronize()
        res.window_s, res.units = time.perf_counter() - t0, n
    else:
        n = tr["trace_steps"]
        profile = trace.profiler() if rank == 0 else contextlib.nullcontext()
        rec = trace.Recorder()
        if rank == 0:
            trace.wrap_norms(state.model, rec, Norm32)
        with profile as prof:
            t0 = time.perf_counter()
            for i in range(n):
                with trace.span("pb.step"):
                    step(first + i)
            ctx.synchronize()
            res.window_s, res.units = time.perf_counter() - t0, n
        if rank == 0:
            red = trace.reduce(trace.trace_events(prof), spans=("pb.", "tq::"))
            model = flops.unet_train_step(cell.config["unet"], tr["batch"],
                                          cell.config["model_shape"][:-1])
            res.layer = {"trace": red, "model_flops": model * n, "gn_bytes": rec.gn_bytes}
    ctx.window_closed()
    dist.all_reduce(bad)
    peak = torch.tensor([ctx.memory_peak_bytes], dtype=torch.int64)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=host)
    dist.barrier(group=host)
    res.failed = int(bad)
    if rank:
        return None
    del state, train_step, loader, feed, names
    ctx.free()
    if ctx.control == "lowp_reference":  # the reference one precision down, in the program's place
        from portbench.reference import lowp

        program = reference_steps(cell, ctx, lowp.fp8)
    res.readings = tk.compare(program, reference_steps(cell, ctx)) | {"rank_gap": rank_gap}
    return {"result": res, "opened": opened, "memory_peak_bytes": int(peak)}


@torch.no_grad()
def _rank_gap(params) -> float:
    """The largest |p - p on rank 0| over ``params`` and every rank."""
    import torch.distributed as dist

    flat = torch.cat([p.detach().reshape(-1).float() for p in params])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    gap = (flat - ref).abs().max().reshape(1)
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    return float(gap)


def reference_steps(cell, ctx, lowp_fn=None) -> dict:
    """``kinds/train.py``'s reference over the global batch of every checked
    step: rank r's rows of step n are its loader's, in rank order, and its
    dropout masks are drawn from its own seed."""
    from portbench.harness import checks, inputs
    from portbench.reference import diffusion as ref_diffusion
    from portbench.reference import nets
    from portbench.reference import signal as ref_signal

    tk = _train()
    cfg, tr, tcfg = cell.config, cell.traffic, cell.config["train"]
    b, block, world = tr["batch"], tr["reference_block"], cell.chips
    with checks.reference_precision(grad=True):
        P = tk.weights(cell, ctx)
        theta0 = {k: v.clone() for k, v in P.items()}
        trainable = [k for k in P if not k.endswith(".W")]
        for k in trainable:
            P[k].requires_grad_(True)
        with torch.no_grad():
            waves, cond = tk.data(cell, ctx)
            signal = ref_signal.envelope(waves).movedim(1, -1).contiguous()
            del waves
        perm = np.random.default_rng(tk.loader_seed(ctx)).permutation(
            tr["dataset_rows"] // world)
        adam = ref_diffusion.Adam({k: P[k] for k in trainable}, tcfg["learning_rate"],
                                  max_steps(cell))
        ema = {k: v.detach().clone() for k, v in P.items()}
        out = {"losses": []}
        gen = torch.Generator(device=ctx.device)
        for n in range(tr["checked_steps"]):
            rows = np.concatenate([shard(cell, r).start + perm[n * b:(n + 1) * b]
                                   for r in range(world)])
            idx = torch.from_numpy(rows).to(ctx.device)
            sample, c = signal.index_select(0, idx), cond.index_select(0, idx)
            seed_step(ctx, gen, n, 0)
            sigma_eps = torch.randn((b * world,), generator=gen, device=ctx.device)
            noise = torch.randn(sample.shape, generator=gen, device=ctx.device)
            masks = []
            for r in range(world):
                seed_step(ctx, torch.Generator(device=ctx.device), n, r)
                masks.append(tk.dropout_masks(cell, ctx, b))
            masks = [torch.cat(m) for m in zip(*masks)]
            total = 0.0
            for s in range(0, b * world, block):
                e = min(s + block, b * world)
                ops = nets.Ops(cfg["unet"]["dropout"], [m[s:e] for m in masks], lowp_fn)

                def net(x, t, c=c[s:e], ops=ops):
                    return nets.unet(P, cfg["unet"], x, t, c, ops)

                loss = ref_diffusion.loss(net, sample[s:e], sigma_eps[s:e], noise[s:e])
                (loss * (e - s) / (b * world)).backward()
                total += float(loss.detach()) * (e - s) / (b * world)
            out["losses"].append(total)
            grads = {k: P[k].grad for k in trainable}
            if n == 0:
                out["grad_t"] = {k: g.detach().clone() for k, g in grads.items()}
                out["grad"] = {k: float(g.norm()) for k, g in grads.items()}
            adam.update({k: P[k].data for k in trainable}, grads)
            for k in trainable:
                P[k].grad = None
            ref_diffusion.ema_update(ema, {k: v.detach() for k, v in P.items()},
                                     tcfg["ema_decay"])
        with torch.no_grad():
            out["delta"] = {k: P[k].detach() - theta0[k] for k in trainable}
            out["ema_delta"] = {k: ema[k] - theta0[k] for k in trainable}
    return out


if __name__ == "__main__":
    rank_main(sys.argv[1])
