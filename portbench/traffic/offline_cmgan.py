"""Offline enhancement with CMGAN's generator: padded batches of PCM16 clips
through ``AudioEnhancer.enhance_batch_async``, two batches in flight, as
``offline_batches`` drives the HybridViT, on the port's ``models.create_model``
with the configuration's ``architecture``.

Parameters: those of ``offline_batches`` (``lengths``, ``pool``, ``batch``,
``check_batches``), and ``relpos_term`` (default true; false zeroes the
program's relative-position tables and not the reference's: the stand-in
that drops the term, which has to come out not correct).

The batches are ``offline_batches.make_batches``'s, in its order. The
window runs whole passes of them: it ends at the first end of a pass after
``--seconds`` (a pass of the cell's pool is ~37 s on an H100), so the rate
is all of a pass's audio over its time, whichever batches the seed puts
first.

Weights: ``weights.draw``, then the leaves in ``SCALED`` multiplied by their
factor. The relative-position tables at the harness's N(0, 0.02) move the
logits by ~0.003, under any limit; at N(0, 3) the stand-in without them fails.
The decoders' last convs at the harness's N(0, 2/fan_out) (fan_out 1 or 4)
make the output ~8x the compressed input, ~1,000x after decompression, and
every sample would clip; and the mask is one drawn scalar (the 1x1
``final_conv``) times a normalised signal, so its level, raised to the power
1/0.3, moved the output's level ~100x between seeds. Scaled: the complex
decoder's conv (a sum over 128 weights, steady between seeds) carries the
output at ~0.7x the input's level, the mask's scalar a small share of it.

The traced slice (``--trace 1``) is one more whole pass, the window's mix,
so that its rooflines are the window's. In it the port's recorder is on, and
the device is drained before each batch's dispatch: its ``cmgan.tscb`` spans
then time the host's launches of the conformer blocks against an empty launch
queue (``tscb_launch_ms``), where two batches in flight would time the
device's pace.
"""

from __future__ import annotations

import time
from collections import deque

import torch

from .. import T_START, checks, clips, cmgan_work, system, weights, work
from ..reference import cmgan as reference
from ..reference.hvit import lower_precision
from .offline_batches import make_batches

# name suffix -> factor on weights.draw's value
SCALED = {
    "rel_pos_emb.weight": 150.0,         # N(0, 0.02) -> N(0, 3)
    "complex_decoder.conv.weight": 0.15,
    "mask_decoder.final_conv.weight": 0.05,
}


def draw(shapes: dict, seed: int, device, relpos_term: bool = True) -> dict:
    """The seed's weights of ``shapes`` (see the module docstring)."""
    w = weights.draw(shapes, seed, device)
    for name in w:
        for suffix, factor in SCALED.items():
            if name.endswith(suffix):
                w[name] = w[name] * (factor if relpos_term or suffix != "rel_pos_emb.weight"
                                     else 0.0)
    return w


def build_model(config: dict, seed: int, device, relpos_term: bool = True):
    """``(model, shapes)``: the port's model of ``config`` on ``device`` in
    eval mode with the seed's weights."""
    model = system.port("models").create_model(system.port_config(config)).to(device)
    shapes = weights.float_shapes(model)
    w = draw(shapes, seed, device, relpos_term)
    with torch.no_grad():
        state = model.state_dict()
        for name, t in w.items():
            state[name].copy_(t)
    return model.eval(), shapes


def reference_enhance(config: dict, seed: int, batches: list, device, shapes: dict,
                      tf32: bool = False) -> list:
    """The reference's outputs of ``batches`` (``(padded_len, clips)``), in
    blocks of ``reference.block_rows``; weights drawn again from the seed."""
    p = draw(shapes, seed, device)
    hop = int(config["audio"]["hop_length"])
    outs = []
    with lower_precision(tf32):
        for padded_len, rows in batches:
            step = reference.block_rows(padded_len, hop)
            for i in range(0, len(rows), step):
                outs.extend(reference.enhance_rows(p, config, rows[i:i + step], padded_len,
                                                   device))
    del p
    return outs


def run(ctx) -> dict:
    p, config, dev = ctx.params, ctx.config, ctx.device
    span = ctx.spans.span
    system.use_precision(config)
    tracing = system.port("utils.tracing")
    with span("inputs"):
        batches = make_batches(ctx)
        floats = [[clips.to_float(c) for c in rows] for _, rows in batches]
    inference = system.port("inference")
    with span("build"):
        model, shapes = build_model(config, ctx.seed, dev, bool(p.get("relpos_term", True)))
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
    a = config["audio"]

    def work_of(j):
        n, rows = batches[j]
        lens = [len(r) for r in rows]
        return (cmgan_work.enhance_flops(config, len(rows), n, lens),
                cmgan_work.relpos_work(config, len(rows), n, lens),
                work.stft_work(a["n_fft"], a["hop_length"], len(rows), n))

    def drive(seconds, k, drain=False, traced=None):
        """Batches from the ``k``-th on (``k`` at the start of a pass), two
        in flight, until ``seconds`` have passed and the pass under way is
        whole, then every output read back; ``drain``: the device drained
        before each dispatch. ``(next k, audio-seconds, FLOPs, clips)``."""
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
        while True:
            j = k % len(batches)
            if drain:
                torch.cuda.synchronize(dev)
            with span("dispatch"):
                inflight.append((j, enhancer.enhance_batch_async(floats[j])))
            if traced is not None:
                traced.append(j)
            k += 1
            if len(inflight) == 2:
                read_one()
            if k % len(batches) == 0 and time.perf_counter() - t >= seconds:
                break
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
        tracing.clear()
        tracing.enable()
        ctx.tracer.start()
        _, _, slice_flops, _ = drive(0.0, k, drain=True, traced=traced)
        ctx.tracer.stop()
        tracing.disable()
        tscb = [s.end - s.start for s in tracing.spans() if s.name == "cmgan.tscb"]
        ctx.facts.update(slice_flops=slice_flops, slice_s=ctx.tracer.t1 - ctx.tracer.t0,
                         traced_relpos=[w for j in traced for w in work_of(j)[1]],
                         traced_dsp=[work_of(j)[2] for j in traced],
                         tscb_launch_ms=1e3 * sum(tscb) / len(traced) if tscb else None)
    del enhancer, model, floats
    checked = sorted(kept)

    def check():
        chosen = [batches[j] for j in checked]
        outs = [o for j in checked for o in kept[j]]
        refs = reference_enhance(config, ctx.seed, chosen, dev, shapes)
        numbers = checks.enhancement_gaps(outs, refs)
        ctrl = None
        if ctx.control:
            low = reference_enhance(config, ctx.seed, chosen, dev, shapes, tf32=True)
            ctrl = checks.enhancement_gaps(low, refs)
        return numbers, ctrl

    return {"e2e": {"enhance_audio_s_per_s": done_audio / window, "setup_s": setup_s},
            "attempted": n_clips, "failed": 0, "check": check}
