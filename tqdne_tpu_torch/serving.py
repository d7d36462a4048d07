"""HTTP serving for waveform generation: the port of ``tqdne_tpu/serving.py``.

A long-lived server holds one ``InferenceBundle`` on the card and answers
``POST /generate`` requests through a micro-batcher:

- **one device batch**: every batch runs at one fixed size; partial batches
  are padded with zero rows, so a seeded result does not depend on how the
  requests were packed;
- **micro-batching**: concurrent requests are coalesced into one device
  batch within a small latency window;
- **one device owner**: a single worker thread issues all device work, on
  its current CUDA stream (the kernels launch on the calling thread's
  current stream), so the kernels' launch counters stay exact;
- **two-stage pipeline**: after issuing a batch (sampling and Griffin-Lim,
  which run on the device), the device owner starts the copy of its
  waveforms into pinned host memory without blocking, records a CUDA event
  and hands (batch, device tensor, host buffer, event) to a finalizer
  thread over a depth-1 queue, then packs and issues the next batch.  The
  finalizer waits on the event (``Event.synchronize`` releases the GIL) and
  scatters rows to the waiting requests.  The device tensor stays referenced
  until its copy has passed.

Request seeds: a request with an explicit ``seed`` runs in its own device
batch, with its generator seeded from (seed, chunk offset), so it repeats
bit for bit; unseeded requests are coalesced and draw from a server-side
counter.
"""

from __future__ import annotations

import base64
import json
import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from tqdne_tpu_torch.utils import fold_seed

logger = logging.getLogger("tqdne_tpu_torch.serve")

FEATURES = ("hypocentral_distance", "magnitude", "vs30", "hypocentre_depth",
            "azimuthal_gap")
MAX_REQUEST_ROWS = 1024
# the seeds ``jax.random.key`` takes; the JAX server fails on others
SEED_MIN, SEED_MAX = -2**63, 2**63 - 1


class RequestError(ValueError):
    """Client-side error: malformed conditioning payload."""


@dataclass
class _Pending:
    """One request's accumulation state across its device-batch chunks."""

    n: int
    out: np.ndarray  # (n, channels, t) float32, filled chunk by chunk
    remaining: int
    done: threading.Event = field(default_factory=threading.Event)
    error: Exception | None = None


@dataclass
class _Chunk:
    cond: np.ndarray  # (m, F) normalized float32, m <= batch_size
    pending: _Pending
    offset: int  # row offset of this chunk inside pending.out
    seed: int | None  # not None => run exclusively (deterministic)


@dataclass
class _InFlight:
    """A device result whose copy to pinned host memory is under way."""

    device: torch.Tensor  # kept alive until ``event`` has passed
    host: torch.Tensor
    event: torch.cuda.Event


def _start_copy(out):
    """Start the device-to-host copy of a CUDA result on the current stream
    and record its event; host results pass through."""
    if not (isinstance(out, torch.Tensor) and out.is_cuda):
        return out
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return _InFlight(out, host, event)


def _wait_copy(handle):
    if isinstance(handle, _InFlight):
        handle.event.synchronize()
        return handle.host
    return handle


class Microbatcher:
    """Coalesce concurrent generation requests into fixed-size device batches.

    Decoupled from ``InferenceBundle`` for testability: needs only
    ``run_fn(seed, cond[batch_size, F]) -> waveforms`` (a CUDA tensor, whose
    copy to the host starts as soon as it is issued, or a host array);
    ``fetch_fn`` turns the host copy into a float32 numpy array.  ``fetch_fn``
    runs on the finalizer thread, so the device owner issues the next batch
    meanwhile.
    """

    def __init__(self, run_fn, batch_size: int, n_features: int = len(FEATURES),
                 max_delay_ms: float = 15.0, fetch_fn=None):
        self.run_fn = run_fn
        self.fetch_fn = fetch_fn or (lambda out: np.asarray(out, np.float32))
        self.batch_size = int(batch_size)
        self.n_features = n_features
        self.max_delay = max_delay_ms / 1000.0
        self._cv = threading.Condition()
        self._queue: deque[_Chunk] = deque()
        self._counter = 0  # server-side seed stream for unseeded requests
        self._stop = False
        # at most one batch queued between the device owner and the finalizer
        # (plus the one each is holding): 2-3 batches in flight, bounded memory
        self._inflight: queue.Queue = queue.Queue(maxsize=1)
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="tqdne-serve-batcher")
        self._finalizer = threading.Thread(target=self._finalize_loop,
                                           daemon=True,
                                           name="tqdne-serve-finalizer")
        self.batches_run = 0
        self.rows_served = 0
        self._worker.start()
        self._finalizer.start()

    @classmethod
    def from_bundle(cls, bundle, batch_size: int, max_delay_ms: float = 15.0):
        """Serve ``bundle``: sampling and Griffin-Lim run on its device
        (``InferenceBundle.sampler``), so the host only receives waveforms."""
        return cls(bundle.sampler(batch_size), batch_size, max_delay_ms=max_delay_ms)

    # -- client side ------------------------------------------------------

    def submit(self, cond: np.ndarray, seed: int | None = None) -> _Pending:
        """Enqueue ``cond`` (n, F) normalized rows; returns the pending
        handle (wait on .done, read .out).  ``seed``: an integer of the JAX
        key's range, a signed 64-bit one."""
        cond = np.asarray(cond, np.float32)
        if cond.ndim != 2 or cond.shape[1] != self.n_features:
            raise RequestError(
                f"conditioning must be (n, {self.n_features}), got {cond.shape}")
        n = len(cond)
        if n == 0:
            raise RequestError("empty conditioning")
        if n > MAX_REQUEST_ROWS:
            raise RequestError(
                f"request of {n} rows exceeds the per-request cap "
                f"{MAX_REQUEST_ROWS}; split it client-side")
        if seed is not None and not SEED_MIN <= seed <= SEED_MAX:
            raise RequestError(f"seed must be a signed 64-bit integer, got {seed}")
        pending = _Pending(n=n, out=np.empty((n, 0, 0), np.float32), remaining=0)
        chunks = []
        for off in range(0, n, self.batch_size):
            rows = cond[off:off + self.batch_size]
            chunks.append(_Chunk(cond=rows, pending=pending, offset=off, seed=seed))
        pending.remaining = len(chunks)
        with self._cv:
            if self._stop:
                raise RuntimeError("server is shutting down")
            self._queue.extend(chunks)
            self._cv.notify_all()
        return pending

    def generate(self, cond: np.ndarray, seed: int | None = None,
                 timeout: float = 300.0) -> np.ndarray:
        """Blocking submit: returns (n, channels, t) float32 waveforms."""
        pending = self.submit(cond, seed)
        if not pending.done.wait(timeout):
            raise TimeoutError(f"generation did not complete in {timeout}s")
        if pending.error is not None:
            raise pending.error
        return pending.out

    # -- device-owner side --------------------------------------------------

    def _take_batch(self) -> list[_Chunk]:
        """Pop chunks totalling <= batch_size rows, waiting up to max_delay
        for stragglers.  Seeded chunks run exclusively."""
        with self._cv:
            while not self._queue and not self._stop:
                self._cv.wait()
            if self._stop and not self._queue:
                return []
            batch = [self._queue.popleft()]
            if batch[0].seed is not None:
                return batch
            total = len(batch[0].cond)
            deadline = time.monotonic() + self.max_delay
            while total < self.batch_size:
                if self._queue:
                    head = self._queue[0]
                    if head.seed is not None or total + len(head.cond) > self.batch_size:
                        break
                    batch.append(self._queue.popleft())
                    total += len(batch[-1].cond)
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._stop:
                        break
                    self._cv.wait(remaining)
            return batch

    def _loop(self):
        """Device owner: pack requests, issue the sampler and the copy of its
        result, hand the in-flight batch to the finalizer."""
        try:
            while True:
                batch = self._take_batch()
                if not batch:
                    return
                try:
                    handle = _start_copy(self._dispatch(batch))
                except Exception as e:  # an error raised while issuing (bad shapes etc.)
                    logger.exception("serving dispatch failed")
                    self._fail(batch, e)
                    continue
                self._inflight.put((batch, handle))
        finally:
            self._inflight.put(None)  # release the finalizer

    def _dispatch(self, batch: list[_Chunk]):
        cond = np.concatenate([c.cond for c in batch])
        pad = self.batch_size - len(cond)
        if pad:
            cond = np.concatenate([cond, np.zeros((pad, self.n_features), np.float32)])
        if batch[0].seed is not None:
            # deterministic: the seed depends only on the request seed + chunk offset
            seed = fold_seed(batch[0].seed, batch[0].offset)
        else:
            seed = fold_seed(0, self._counter)
            self._counter += 1
        return self.run_fn(seed, cond)

    def _finalize_loop(self):
        """Wait for each batch's copy, then scatter rows to the waiters, while
        the device owner is already issuing the next batch."""
        while True:
            item = self._inflight.get()
            if item is None:
                return
            batch, handle = item
            try:
                self._finalize(batch, handle)
            except Exception as e:  # an asynchronous device error surfaces here
                logger.exception("serving batch failed")
                self._fail(batch, e)

    def _finalize(self, batch: list[_Chunk], handle):
        waveforms = np.asarray(self.fetch_fn(_wait_copy(handle)), np.float32)
        self.batches_run += 1
        off = 0
        for c in batch:
            m = len(c.cond)
            part = waveforms[off:off + m]
            p = c.pending
            if p.out.shape[1:] != part.shape[1:]:
                p.out = np.empty((p.n, *part.shape[1:]), np.float32)
            p.out[c.offset:c.offset + m] = part
            off += m
            self.rows_served += m
            # the LAST finished chunk releases the waiter (dispatch is FIFO
            # on one worker and finalize is FIFO on one finalizer, so chunks
            # of a request complete in order)
            p.remaining -= 1
            if p.remaining == 0:
                p.done.set()

    @staticmethod
    def _fail(batch: list[_Chunk], e: Exception):
        for c in batch:
            c.pending.error = e
            c.pending.done.set()

    def shutdown(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._worker.join(timeout=10)
        self._finalizer.join(timeout=10)


# -- HTTP layer -------------------------------------------------------------


def parse_conditions(payload) -> np.ndarray:
    """Accept [[f1..f5], ...] or [{feature: value, ...}, ...] raw rows."""
    if not isinstance(payload, list) or not payload:
        raise RequestError("'conditions' must be a non-empty list")
    rows = []
    for i, row in enumerate(payload):
        if isinstance(row, dict):
            missing = [k for k in FEATURES if k not in row]
            if missing:
                raise RequestError(
                    f"conditions[{i}] missing {', '.join(missing)}")
            try:
                rows.append([float(row[k]) for k in FEATURES])
            except (TypeError, ValueError) as e:
                raise RequestError(f"conditions[{i}]: non-numeric value ({e})")
        elif isinstance(row, (list, tuple)) and len(row) == len(FEATURES):
            try:
                rows.append([float(v) for v in row])
            except (TypeError, ValueError) as e:
                raise RequestError(f"conditions[{i}]: non-numeric value ({e})")
        else:
            raise RequestError(
                f"conditions[{i}] must be a {len(FEATURES)}-list or a dict "
                f"with keys {', '.join(FEATURES)}")
    return np.array(rows, np.float64)


def make_server(batcher: Microbatcher, normalize_fn, info: dict,
                host: str = "127.0.0.1", port: int = 8000):
    """Build (not start) a ThreadingHTTPServer wired to the batcher.

    Endpoints:
      GET  /healthz   liveness + batches and rows served
      GET  /info      model/config metadata
      POST /generate  {"conditions": [...], "seed"?: int, "format"?: "b64"}
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through logging, not stderr
            logger.info("%s %s", self.address_string(), fmt % args)

        def _send(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True, "batches_run": batcher.batches_run,
                                 "rows_served": batcher.rows_served})
            elif self.path == "/info":
                self._send(200, info)
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                cond_raw = parse_conditions(req.get("conditions"))
                seed = req.get("seed")
                if seed is not None:
                    try:
                        seed = int(seed)
                    except (TypeError, ValueError):
                        raise RequestError(f"seed must be an integer, got {seed!r}")
                cond = normalize_fn(cond_raw).astype(np.float32)
                waveforms = batcher.generate(cond, seed=seed)
            except RequestError as e:
                self._send(400, {"error": str(e)})
                return
            except json.JSONDecodeError as e:
                self._send(400, {"error": f"invalid JSON: {e}"})
                return
            except TimeoutError as e:
                self._send(503, {"error": str(e)})
                return
            except Exception as e:  # pragma: no cover - defensive
                logger.exception("generate failed")
                self._send(500, {"error": str(e)})
                return
            resp = {"shape": list(waveforms.shape), "dtype": "float32"}
            if req.get("format") == "b64":
                # little-endian float32 C-order; 3x smaller than JSON floats
                resp["waveforms_b64"] = base64.b64encode(
                    np.ascontiguousarray(waveforms, "<f4").tobytes()).decode()
            else:
                resp["waveforms"] = waveforms.tolist()
            self._send(200, resp)

    return ThreadingHTTPServer((host, port), Handler)
