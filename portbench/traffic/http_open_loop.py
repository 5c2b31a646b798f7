"""Serving over HTTP, open loop: the port's ``inference.make_server`` (the
dynamic batcher and its HTTP handler threads) around an ``AudioEnhancer``
as ``cli/serve.py`` builds it (PCM16 on the link), in this process; the
clients in a process of their own (``portbench.http_client``).

Parameters: ``rate_per_s`` (Poisson arrivals a second), ``lengths`` (clip
length distribution), ``pool`` (clips made from the seed; each request
takes one), ``max_batch`` and ``max_wait_ms`` (the batcher's), ``threads``
(client sender threads), ``timeout_s``, ``warm_s`` (seconds of the same
traffic before the window, in set-up), ``check_sample`` (replies checked,
drawn from the seed, every request of the longest clip with them).

Every request due in the window counts: its latency runs from its due time
to the last byte of its reply, and one that fails counts as failed and at
the time it gave up. Served audio-seconds a second: the true length of every
reply that came back inside the window, over the window.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from .. import T_START, checks, clips, system, trace, weights
from ..reference.hvit import bucket_len



class SpannedEnhancer:
    """The enhancer the server calls, with a ``enhance`` span around each
    batch it hands over (the benchmark's own span around the call into the
    enhancer layer)."""

    def __init__(self, enhancer, spans):
        self._enhancer = enhancer
        self._spans = spans

    def __getattr__(self, name):
        return getattr(self._enhancer, name)

    def enhance_batch(self, wavs, *args, **kwargs):
        with self._spans.span("enhance"):
            return self._enhancer.enhance_batch(wavs, *args, **kwargs)


def percentile(sorted_values: list, q: float) -> float:
    """Nearest-rank percentile of an ascending list."""
    k = max(0, min(len(sorted_values) - 1, int(np.ceil(q * len(sorted_values))) - 1))
    return sorted_values[k]


def run(ctx) -> dict:
    p, config, dev = ctx.params, ctx.config, ctx.device
    system.use_precision(config)
    root = Path(__file__).resolve().parents[2]
    out_dir = tempfile.mkdtemp(prefix="portbench_")
    client = subprocess.Popen([sys.executable, "-m", "portbench.http_client"], cwd=root,
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                              env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        return _serve(ctx, client, out_dir)
    finally:
        if client.poll() is None:
            client.kill()
        client.wait()
        shutil.rmtree(out_dir, ignore_errors=True)


def _serve(ctx, client, out_dir) -> dict:
    p, config, dev = ctx.params, ctx.config, ctx.device
    inference = system.port("inference")
    with ctx.spans.span("build"):
        model, w = system.build_model(config, ctx.seed, dev)
        shapes = weights.float_shapes(model)
        del w
        enhancer = inference.AudioEnhancer(
            model, system.port_config(config), device=dev, buckets=tuple(config["buckets"]),
            io_dtype="int16", mask_padding=bool(config["mask_padding"]))
    server = inference.make_server(SpannedEnhancer(enhancer, ctx.spans), "127.0.0.1", 0,
                                   max_batch=p["max_batch"], max_wait_ms=p["max_wait_ms"],
                                   timeout_s=p["timeout_s"])
    port = server.server_address[1]
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()

    hop = config["audio"]["hop_length"]
    lengths = clips.lengths_for(p, p["pool"])
    order = clips.rng(ctx.seed, "clips").permutation(len(lengths))
    pool_lengths = [int(lengths[i]) for i in order]  # clip_pool's order
    by_bucket = {}
    for i, n in enumerate(pool_lengths):
        by_bucket.setdefault(bucket_len(n, config["buckets"], hop), i)
    request = dict(p, seed=ctx.seed, seconds=ctx.seconds, port=port, out_dir=out_dir,
                   warm_ids=sorted(by_bucket.values()))
    client.stdin.write(json.dumps(request) + "\n")
    client.stdin.flush()

    # every (bucket, rows) shape the batcher can form, once, on the device
    with ctx.spans.span("warm"):
        for n in sorted(by_bucket):
            for rows in range(1, p["max_batch"] + 1):
                enhancer.enhance_batch([np.zeros(n, np.float32)] * rows)
    _expect(client, "ready")
    client.stdin.write("{}\n")
    client.stdin.flush()
    _expect(client, "warmed")

    batcher = server.batcher
    t0 = time.perf_counter() + p["warm_s"] + 0.05
    client.stdin.write(json.dumps({"t0": t0}) + "\n")
    client.stdin.flush()
    time.sleep(max(0.0, t0 - time.perf_counter()))
    before = dict(batcher.stats)
    setup_s = t0 - T_START
    if ctx.tracer.enabled:
        a, b = trace.slice_bounds(t0, ctx.seconds)
        time.sleep(max(0.0, a - time.perf_counter()))
        ctx.tracer.start()
        time.sleep(max(0.0, b - time.perf_counter()))
        ctx.tracer.stop()
    done = _expect(client, "done")
    after = dict(batcher.stats)
    server.shutdown()
    batcher.close()
    server.server_close()
    serving.join(timeout=10)
    del enhancer, model, server, batcher

    with np.load(done["done"]) as f:
        res = {k: f[k] for k in f.files}
    due, end, status, which = res["due"], res["end"], res["status"], res["which"]
    ok = status == 200
    t1 = float(end.max()) if len(end) else t0
    lat = np.where(ok, end - due, np.maximum(end - due, t1 - due))
    lat_ms = sorted((lat * 1e3).tolist())
    ctx.facts.update(window_s=t1 - t0, t0=t0, t1=t1,
                     batches=after["batches"] - before["batches"],
                     batched_requests=after["batched_requests"] - before["batched_requests"])
    replies = {int(i): res[f"r{int(i)}"] for i in res["reply_ids"]}
    sample = [int(i) for i in res["sample"]]
    failed = int((~ok).sum())

    def check():
        pool = clips.clip_pool(ctx.seed, lengths)
        by_len: dict = {}
        for i in sample:
            clip = pool[int(which[i])]
            by_len.setdefault(bucket_len(len(clip), config["buckets"], hop), []).append(
                (i, clip))
        items = [(n, [c for _, c in group]) for n, group in sorted(by_len.items())]
        outs = [replies.get(i) for _, group in sorted(by_len.items()) for i, _ in group]
        return checks.enhancement_check(config, ctx.seed, dev, shapes, items, outs,
                                        ctx.control)

    seconds_of = np.array([lengths[i] for i in order], np.float64)[which] / clips.SAMPLE_RATE
    in_window = ok & (end >= t0) & (end < t0 + ctx.seconds)
    served = float(seconds_of[in_window].sum()) / ctx.seconds
    third = len(lat) // 3
    readings = {"lag_after_window_s": t1 - (t0 + ctx.seconds),
                "sender_late_p99_ms": float(np.percentile(res["start"] - due, 99) * 1e3),
                "p95_first_third_ms": float(np.percentile(lat[:third], 95) * 1e3),
                "p95_last_third_ms": float(np.percentile(lat[-third:], 95) * 1e3),
                "connect_p99_ms": float(np.percentile(res["connect"], 99) * 1e3),
                "connects_over_500ms": int((res["connect"] > 0.5).sum())}
    return {"e2e": {"latency_p95_ms": percentile(lat_ms, 0.95),
                    "latency_p50_ms": percentile(lat_ms, 0.50),
                    "serve_audio_s_per_s": served, "setup_s": setup_s},
            "attempted": len(due), "failed": failed, "check": check, "readings": readings}


def _expect(client, key: str) -> dict:
    line = client.stdout.readline()
    if not line:
        raise RuntimeError(f"the HTTP client ended before {key!r} (exit {client.wait()})")
    msg = json.loads(line)
    if key not in msg:
        raise RuntimeError(f"the HTTP client said {msg}, not {key!r}")
    return msg
