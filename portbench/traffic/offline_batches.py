"""Offline enhancement: padded batches of PCM16 clips through
``AudioEnhancer.enhance_batch_async``, two batches in flight, bypassing HTTP
and the batcher.

Parameters: ``lengths`` (the clip length distribution), ``pool`` (clips
made from the seed), ``batch`` (rows a batch), ``check_batches`` (batches
whose rows are checked, drawn from the seed, the longest among them).

The clips are length-sorted and cut into batches as
``enhance_directory`` sorts them; the window walks the batches in the seed's
order, and again from the start if it runs out; a traced run then profiles
further batches for ``trace.TRACE_SECONDS``. Host arrays in and out:
float clips in (PCM16 / 32768, as the WAV reader gives them), PCM16 on the
link (``io_dtype="int16"``), float32 rows out, each trimmed to its clip.
"""

from __future__ import annotations

import time
from collections import deque

from .. import T_START, checks, clips, system, trace, weights, work
from ..reference.hvit import bucket_len



def make_batches(ctx) -> list:
    """``[(padded_len, [PCM16 clips])]`` in the window's order."""
    p, audio = ctx.params, ctx.config["audio"]
    pool = clips.clip_pool(ctx.seed, clips.lengths_for(p, p["pool"]))
    pool.sort(key=len)
    batches = []
    for i in range(0, len(pool), p["batch"]):
        rows = pool[i:i + p["batch"]]
        batches.append((bucket_len(len(rows[-1]), ctx.config["buckets"], audio["hop_length"]),
                        rows))
    order = clips.rng(ctx.seed, "order").permutation(len(batches))
    return [batches[i] for i in order]


def run(ctx) -> dict:
    p, config, dev = ctx.params, ctx.config, ctx.device
    span = ctx.spans.span
    system.use_precision(config)
    with span("inputs"):
        batches = make_batches(ctx)
        floats = [[clips.to_float(c) for c in rows] for _, rows in batches]
    inference = system.port("inference")
    with span("build"):
        model, w = system.build_model(config, ctx.seed, dev)
        shapes = weights.float_shapes(model)
        del w
        enhancer = inference.AudioEnhancer(
            model, system.port_config(config), device=dev, buckets=tuple(config["buckets"]),
            io_dtype="int16", mask_padding=bool(config["mask_padding"]))
    with span("warm"):
        for shape in {(len(rows), n) for n, rows in batches}:  # every batch shape, once
            i = next(j for j, (n, rows) in enumerate(batches) if (len(rows), n) == shape)
            enhancer.enhance_batch_async(floats[i]).result()

    g = clips.rng(ctx.seed, "check")
    longest = max(range(len(batches)), key=lambda j: batches[j][0])
    wanted = set(g.choice(len(batches), min(p["check_batches"], len(batches)),
                          replace=False).tolist()) | {longest}
    kept: dict = {}
    spec = work.spec_from_config(config["model"])
    a = config["audio"]

    def work_of(j):
        n, rows = batches[j]
        lens = [len(r) for r in rows]
        f_bins = a["n_fft"] // 2 + 1
        frames = work.num_frames(a["n_fft"], a["hop_length"], n)
        dsp = work.stft_work(a["n_fft"], a["hop_length"], len(rows), n)
        attn = work.attention_work(spec, f_bins, frames, a["hop_length"],
                                   lens if config["mask_padding"] else None, len(rows))
        return (work.enhance_flops(spec, len(rows), a["n_fft"], a["hop_length"], n),
                attn["fwd"], dsp)

    def drive(seconds, k, traced=None):
        """Batches from the ``k``-th on, two in flight, until ``seconds``
        have passed, then every output read back: ``(next k, audio-seconds,
        FLOPs, clips)``."""
        inflight: deque = deque()
        done = [0.0, 0.0, 0]

        def read_one():
            j, pending = inflight.popleft()
            with span("result"):
                out = pending.result()
            rows = batches[j][1]
            if j in wanted and j not in kept:
                kept[j] = [out[r, :len(c)].copy() for r, c in enumerate(rows)]
            done[0] += sum(len(c) for c in rows) / clips.SAMPLE_RATE
            done[1] += work_of(j)[0]
            done[2] += len(rows)

        t = time.perf_counter()
        while time.perf_counter() - t < seconds:
            j = k % len(batches)
            with span("dispatch"):
                inflight.append((j, enhancer.enhance_batch_async(floats[j])))
            if traced is not None:
                traced.append(j)
            k += 1
            if len(inflight) == 2:
                read_one()
        while inflight:
            read_one()
        return (k, *done)

    t0 = time.perf_counter()
    setup_s = t0 - T_START
    k, done_audio, flops, n_clips = drive(ctx.seconds, 0)
    t1 = time.perf_counter()
    window = t1 - t0
    ctx.facts.update(window_s=window, window_flops=flops, t0=t0, t1=t1)
    if ctx.tracer.enabled:
        traced = []
        ctx.tracer.start()
        _, _, slice_flops, _ = drive(trace.TRACE_SECONDS, k, traced)
        ctx.tracer.stop()
        ctx.facts.update(slice_flops=slice_flops, slice_s=ctx.tracer.t1 - ctx.tracer.t0,
                         traced_attention=[work_of(j)[1] for j in traced],
                         traced_dsp=[work_of(j)[2] for j in traced])
    del enhancer, model, floats
    checked = sorted(kept)

    def check():
        return checks.enhancement_check(
            config, ctx.seed, dev, shapes, [batches[j] for j in checked],
            [o for j in checked for o in kept[j]], ctx.control)

    return {"e2e": {"enhance_audio_s_per_s": done_audio / window, "setup_s": setup_s},
            "attempted": n_clips, "failed": 0, "check": check}
