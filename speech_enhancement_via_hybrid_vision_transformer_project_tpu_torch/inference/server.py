"""Batched enhancement server (JAX ``inference/server.py``, same protocol).

An HTTP front end with a dynamic batcher that coalesces concurrent
requests into padded length-bucketed batches for the enhancer.

  * One worker thread owns the device (the CUDA card); HTTP threads only
    parse, queue and wait.
  * Requests wait at most ``max_wait_ms`` for peers, up to ``max_batch``;
    the batcher groups them by length bucket so one request never pays
    another's padding.
  * stdlib only (http.server).

Protocol:
  POST /enhance  body = WAV bytes (PCM16/24/32 or float32; any sample
                 rate — resampled to the model rate on ingest)
                 -> 200, body = enhanced WAV (IEEE float32, model sample
                 rate; lossless w.r.t. the pipeline output). Clips longer
                 than the largest length bucket are enhanced via the
                 streaming chunked-overlap-add path.
  GET  /healthz  -> 200 "ok"
  GET  /stats    -> 200 JSON {requests, audio_seconds, audio_seconds_per_s,
                              batches, mean_batch_size, queue_wait_ms_mean,
                              process_ms_mean, padding_pct}

/stats since the server started: ``queue_wait_ms_mean`` is a request's mean
wait from its handler's ``submit`` to the batcher taking it;
``process_ms_mean`` a batch's mean time in the enhancer (one length bucket's
``enhance_batch``, its output on the host); ``padding_pct`` the share of the
samples of the batched requests' length buckets that were padding.

The handler and the batcher also time ``serve.parse``, ``serve.reply``,
each request's ``serve.queue_wait``, ``serve.collect`` and ``serve.process``
as spans of the port's recorder (``utils/tracing.py``) under the request's
id (``serve.process``: its first request's). The server never turns the
recorder on: a caller that measures the server in its own process does.
"""

from __future__ import annotations

import itertools
import json
import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from ..data.wavio import read_wav_bytes, wav_bytes
from ..utils import tracing

_request_ids = itertools.count(1)


@dataclass
class _Request:
    audio: np.ndarray
    sample_rate: int
    id: int = 0
    submitted: float = 0.0
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[str] = None


class DynamicBatcher:
    """Coalesce concurrent enhancement requests into bucketed batches."""

    def __init__(
        self,
        enhancer,
        *,
        max_batch: int = 16,
        max_wait_ms: float = 10.0,
    ):
        self.enhancer = enhancer
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.queue: "queue.Queue[_Request]" = queue.Queue()
        self.stats = {
            "requests": 0,
            "audio_seconds": 0.0,
            "batches": 0,
            "batched_requests": 0,
            "queue_wait_s": 0.0,
            "process_s": 0.0,
            "true_samples": 0,
            "padded_samples": 0,
        }
        self._t0 = time.perf_counter()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, req: _Request) -> None:
        req.submitted = time.perf_counter()
        self.queue.put(req)

    def close(self) -> None:
        self._stop.set()
        self._worker.join(timeout=5.0)

    # ------------------------------------------------------------------
    def _collect(self) -> List[_Request]:
        """Block for one request, then sweep peers for up to max_wait."""
        try:
            first = self.queue.get(timeout=0.1)
        except queue.Empty:
            return []
        self._taken(first)
        batch = [first]
        with tracing.span("serve.collect", first.id):
            deadline = time.perf_counter() + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._taken(self.queue.get(timeout=remaining)))
                except queue.Empty:
                    break
        return batch

    def _taken(self, req: _Request) -> _Request:
        """Count ``req``'s wait in the queue, which ends now."""
        now = time.perf_counter()
        self.stats["queue_wait_s"] += now - req.submitted
        tracing.record("serve.queue_wait", req.submitted, now, req.id)
        return req

    def _max_samples(self) -> int:
        """Capacity of the largest length bucket (samples)."""
        return (max(self.enhancer.buckets) - 1) * self.enhancer.stft_cfg.hop_length

    def _process(self, batch: List[_Request]) -> None:
        # group by length bucket so short clips don't pay a long clip's
        # padding
        groups: dict = {}
        for r in batch:
            if len(r.audio) > self._max_samples():
                groups.setdefault("stream", []).append(r)
            else:
                groups.setdefault(self.enhancer._padded_len(len(r.audio)), []).append(r)
        for key, reqs in groups.items():
            t0 = time.perf_counter()
            try:
                with tracing.span("serve.process", reqs[0].id):
                    if key == "stream":
                        # longer than the largest bucket: chunked overlap-add
                        # path (batched enhance would silently truncate)
                        for r in reqs:
                            r.result = self.enhancer.enhance_streaming(r.audio)
                    else:
                        # eager PyTorch compiles nothing per batch shape, so
                        # the batch is not padded to a fixed set of sizes
                        outs = self.enhancer.enhance_batch([r.audio for r in reqs])
                        for r, out in zip(reqs, outs):
                            r.result = out
                        self.stats["true_samples"] += sum(len(r.audio) for r in reqs)
                        self.stats["padded_samples"] += key * len(reqs)
            except Exception as e:  # fail these requests, keep serving
                traceback.print_exc()
                for r in reqs:
                    r.error = str(e)
            self.stats["process_s"] += time.perf_counter() - t0
            self.stats["batches"] += 1
            self.stats["batched_requests"] += len(reqs)
            for r in reqs:
                self.stats["requests"] += 1
                self.stats["audio_seconds"] += len(r.audio) / max(
                    r.sample_rate, 1
                )
                r.done.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            try:
                self._process(batch)
            except Exception as e:  # never let the device worker die
                traceback.print_exc()
                for r in batch:
                    if not r.done.is_set():
                        r.error = str(e)
                        r.done.set()
        # drain: fail queued requests instead of leaving handlers blocked
        while True:
            try:
                r = self.queue.get_nowait()
            except queue.Empty:
                break
            r.error = "server shutting down"
            r.done.set()

    # ------------------------------------------------------------------
    def stats_snapshot(self) -> dict:
        s = dict(self.stats)
        elapsed = max(time.perf_counter() - self._t0, 1e-9)
        s["audio_seconds_per_s"] = s["audio_seconds"] / elapsed
        s["mean_batch_size"] = (
            s["batched_requests"] / s["batches"] if s["batches"] else 0.0
        )
        s["queue_wait_ms_mean"] = (
            1e3 * s["queue_wait_s"] / s["requests"] if s["requests"] else 0.0
        )
        s["process_ms_mean"] = 1e3 * s["process_s"] / s["batches"] if s["batches"] else 0.0
        s["padding_pct"] = (
            100.0 * (1.0 - s["true_samples"] / s["padded_samples"]) if s["padded_samples"] else 0.0
        )
        return s


def make_server(
    enhancer,
    host: str = "127.0.0.1",
    port: int = 0,
    *,
    max_batch: int = 16,
    max_wait_ms: float = 10.0,
    timeout_s: float = 120.0,
) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; ``server.batcher`` is attached."""
    batcher = DynamicBatcher(
        enhancer, max_batch=max_batch, max_wait_ms=max_wait_ms
    )
    target_sr = enhancer.sample_rate

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, b"ok", "text/plain")
            elif self.path == "/stats":
                self._reply(
                    200,
                    json.dumps(batcher.stats_snapshot()).encode(),
                    "application/json",
                )
            else:
                self._reply(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/enhance":
                self._reply(404, b"not found", "text/plain")
                return
            n = int(self.headers.get("Content-Length", 0))
            if n <= 0:
                self._reply(400, b"empty body", "text/plain")
                return
            rid = next(_request_ids)
            try:
                with tracing.span("serve.parse", rid):
                    audio, sr = read_wav_bytes(self.rfile.read(n), target_sr)
            except Exception as e:
                self._reply(400, f"bad wav: {e}".encode(), "text/plain")
                return
            req = _Request(audio=audio, sample_rate=sr, id=rid)
            batcher.submit(req)
            if not req.done.wait(timeout=timeout_s):
                self._reply(503, b"timeout", "text/plain")
                return
            if req.error is not None:
                self._reply(500, req.error.encode(), "text/plain")
                return
            # float32 WAV: lossless w.r.t. the pipeline output (PCM16 would
            # clip if an output excursion exceeds full scale)
            with tracing.span("serve.reply", rid):
                self._reply(
                    200, wav_bytes(req.result, sr, subtype="float32"), "audio/wav"
                )

    server = ThreadingHTTPServer((host, port), Handler)
    server.batcher = batcher  # type: ignore[attr-defined]
    return server
