"""The open-loop HTTP client of the serving cells, in a process of its own so
that it does not share the server's interpreter lock.

    python -m portbench.http_client   (driven over stdin/stdout, one JSON
                                       object a line; see ``serve``)

It makes the cell's clips from the seed (numpy only), sends one request per
bucket to warm the server when told, then ``warm_s`` seconds of the same
open loop before the window (not counted: the host's allocators and the
server's threads reach their steady state there), then POSTs each request
of the window at its due time whatever came back before (a request waits for a free sender thread
when all are busy, and that wait is in its latency). Each request is timed
from its due time to the last byte of its reply. The replies of the sampled
requests are kept for the correctness check.
"""

from __future__ import annotations

import http.client
import json
import struct
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from . import clips


def wav_pcm16(x: np.ndarray, sample_rate: int = clips.SAMPLE_RATE) -> bytes:
    data = x.astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, sample_rate, sample_rate * 2, 2, 16)
    return (b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data)) + b"WAVE"
            + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(data)) + data)


def read_wav_float32(body: bytes) -> np.ndarray:
    """The samples of an IEEE float32 WAV (the server's reply)."""
    if body[:4] != b"RIFF" or body[8:12] != b"WAVE":
        raise ValueError("not a WAV")
    i, fmt = 12, None
    while i + 8 <= len(body):
        tag, size = body[i:i + 4], struct.unpack("<I", body[i + 4:i + 8])[0]
        if tag == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[i + 8:i + 24])
        elif tag == b"data":
            if fmt is None or fmt[0] != 3 or fmt[5] != 32:
                raise ValueError(f"reply is not float32 WAV: {fmt}")
            return np.frombuffer(body[i + 8:i + 8 + size], dtype="<f4").copy()
        i += 8 + size + (size & 1)
    raise ValueError("WAV without data")


def schedule(p: dict, stream: str = "") -> tuple[np.ndarray, np.ndarray]:
    """``(due offsets in s, pool index of each request)`` of the window, or
    of the warm traffic before it (``stream="warm"``, offsets below 0)."""
    seconds = p["warm_s"] if stream else p["seconds"]
    offsets = clips.poisson_offsets(p["rate_per_s"], seconds, p["seed"], stream)
    offsets = offsets[offsets < seconds]
    which = clips.rng(p["seed"], "assign" + stream).integers(0, p["pool"], len(offsets))
    return (offsets - seconds if stream else offsets), which


def sample_ids(p: dict, n_requests: int, which: np.ndarray, lengths: list) -> set:
    """The requests whose replies are checked: ``check_sample`` drawn from
    the seed, and every request of the longest clip."""
    g = clips.rng(p["seed"], "sample")
    ids = set(g.choice(n_requests, min(p["check_sample"], n_requests), replace=False).tolist())
    longest = int(np.argmax(lengths))
    ids.update(np.flatnonzero(which == longest).tolist())
    return ids


def _post(port: int, body: bytes, timeout: float) -> tuple[int, bytes, float]:
    """``(status, reply, seconds the TCP connect took)``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t = time.perf_counter()
        conn.connect()
        connect_s = time.perf_counter() - t
        conn.request("POST", "/enhance", body=body, headers={"Content-Type": "audio/wav"})
        resp = conn.getresponse()
        return resp.status, resp.read(), connect_s
    finally:
        conn.close()


def serve(stdin, stdout) -> None:
    def say(obj):
        stdout.write(json.dumps(obj) + "\n")
        stdout.flush()

    p = json.loads(stdin.readline())
    lengths = clips.lengths_for(p, p["pool"])
    pool = clips.clip_pool(p["seed"], lengths)
    bodies = [wav_pcm16(c) for c in pool]
    offsets, which = schedule(p)
    sample = sample_ids(p, len(offsets), which, [len(c) for c in pool])
    say({"ready": True})

    json.loads(stdin.readline())  # warm: one request per bucket, in turn
    for i in p["warm_ids"]:
        _post(p["port"], bodies[i], p["timeout_s"])
    say({"warmed": True})

    t0 = json.loads(stdin.readline())["t0"]
    warm_offsets, warm_which = schedule(p, "warm")
    n = len(offsets)
    start, end, connect = np.zeros(n), np.zeros(n), np.zeros(n)
    status = np.zeros(n, np.int32)
    replies: dict = {}
    lock = threading.Lock()

    def send(i: int) -> None:
        start[i] = time.perf_counter()
        try:
            code, body, connect[i] = _post(p["port"], bodies[which[i]], p["timeout_s"])
            if code == 200 and i in sample:
                out = read_wav_float32(body)
                with lock:
                    replies[i] = out
        except (OSError, http.client.HTTPException, ValueError):
            code = -1
        end[i] = time.perf_counter()
        status[i] = code

    def warm(i: int) -> None:
        try:
            _post(p["port"], bodies[warm_which[i]], p["timeout_s"])
        except (OSError, http.client.HTTPException):
            pass

    with ThreadPoolExecutor(max_workers=p["threads"]) as pool_ex:
        futures = []
        for i, off in enumerate(warm_offsets):
            delay = t0 + off - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            futures.append(pool_ex.submit(warm, i))
        for i, off in enumerate(offsets):
            delay = t0 + off - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            futures.append(pool_ex.submit(send, i))
        for f in futures:
            f.result()
    out = Path(p["out_dir"]) / "replies.npz"
    keys = sorted(replies)
    np.savez(out, due=t0 + offsets, start=start, end=end, connect=connect, status=status,
             which=which,
             sample=np.array(sorted(sample), np.int64), reply_ids=np.array(keys, np.int64),
             **{f"r{i}": replies[i] for i in keys})
    say({"done": str(out)})


if __name__ == "__main__":
    serve(sys.stdin, sys.stdout)
