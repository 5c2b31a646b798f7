"""Offline enhancement with SEMamba's generator: padded batches of PCM16
clips through ``AudioEnhancer.enhance_batch_async``, two batches in flight,
as ``offline_cmgan`` drives CMGAN, on the port's ``models.create_model``
with the configuration's ``architecture``.

Parameters: those of ``offline_batches`` (``lengths``, ``pool``, ``batch``,
``check_batches``), and ``fault`` (default none): a stand-in put in place
of the program's scan, which has to come out not correct: ``reset64`` (each
scan's state reset every 64 steps), ``reverse_from_end`` (the backward time
scans started at the bucket's last frame rather than each row's last valid
one) or ``reverse_is_forward`` (the backward direction's scans run
forward).

The batches are ``offline_batches.make_batches``'s, in its order. The
window runs whole passes of them: it ends at the first end of a pass after
``--seconds``, so the rate is all of a pass's audio over its time, whichever
batches the seed puts first.

Weights: ``weights.draw``, then the published initialisation of the
leaves it sets (Mamba's ``A_log = log(1 .. d_state)`` a channel, ``D = 1``,
Delta's bias the inverse softplus of a step drawn log-uniform in [1e-3,
1e-1] from the seed; MP-SENet's mask slopes 1), then the leaves in ``SCALED`` multiplied by their factor. At the
harness's generic draw ``A_log`` and the bias are ~0, so every state would
decay by ~0.5 a frame and a scan cut to a short window would pass; with the
published values the slowest states keep ~1,000 frames. At the generic
N(0, 0.02) the Mamba layers add ~3e-4 to their unit-scale residual, and no
fault of the scan moved the output by a PCM16 step (2 clips of 1.9 and 2.4
s on the CPU: each fault 0.05 steps RMS from the reference, as the program
is). Scaled, ``in_proj`` and ``conv1d`` at PyTorch's own initial scale,
``x_proj`` so that B and C are of O(1) (the scan's state then carries about
half of the mixer's output) and ``out_proj`` so that a mixer adds ~15% to
its residual: the same clips then read 22 steps RMS with the state reset
every 64 steps, 27 with the backward direction run forward and 2.5 with the
backward time scans started at the bucket's end, against 0.05 for the
program. The mask's last 1x1 conv at He scale (a single weight N(0, 2))
saturates the mask's sigmoid on some seeds, and the output then clips:
scaled, the mask stays within ~0.6-1.5. And the encoder's first conv takes
the phase input at ``PHASE_IN`` times its He scale: MP-SENet's phase input,
``atan2(im + 1e-10, re + 1e-5)``, jumps by 2 pi where the real part is
negative and the imaginary part crosses 0, and two fp32 FFTs (K1 and
``torch.stft``'s) put some such bins on opposite sides. At He scale one such
bin moved a 2-s clip's output by up to 912 PCM16 steps (91 RMS; the CPU, this
weight draw), and 11 of 12 seeds of the cell's first card runs read the
program 182-3,882 steps off the reference, as far as its control; at 1e-4
three such bins moved it by 1 step (0.27 RMS), while the phase input negated
everywhere still moves it by 210 (29 RMS), so the front end's phase stays
checked.

The traced slice (``--trace 1``) is one more whole pass, the window's mix,
so that its rooflines are the window's. In it the port's recorder is on, and
the device is drained before each batch's dispatch: its ``semamba.tfmamba``
spans then time the host's launches of the TFMamba blocks against an empty
launch queue (``tfmamba_launch_ms``).
"""

from __future__ import annotations

import math
import time
from collections import deque

import torch

from .. import T_START, checks, clips, semamba_work, system, weights, work
from ..reference import semamba as reference
from ..reference.hvit import lower_precision
from .offline_batches import make_batches

# name suffix -> factor on the value drawn
SCALED = {
    "mixer.in_proj.weight": 3.6,          # N(0, 0.02) -> N(0, 0.072), nn.Linear's own scale
    "mixer.conv1d.weight": 14.0,          # N(0, 0.02) -> N(0, 0.28), nn.Conv1d's own scale
    "mixer.conv1d.bias": 14.0,
    "mixer.x_proj.weight": 12.5,          # N(0, 0.02) -> N(0, 0.25): B and C of O(1)
    "mixer.out_proj.weight": 5.0,         # N(0, 0.02) -> N(0, 0.1)
    "mask_decoder.mask_conv.4.weight": 0.2,
}
# factor on the encoder's first 1x1 conv's weights on the phase input (its
# second input channel), on top of the He-scale draw (the module docstring)
PHASE_IN = 1e-4
DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 1e-1, 1e-4


def draw(shapes: dict, seed: int, device) -> dict:
    """The seed's weights of ``shapes`` (see the module docstring)."""
    w = weights.draw(shapes, seed, device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) + 1)
    for name in sorted(w):
        if name.endswith(".mixer.A_log"):
            d, n = w[name].shape
            w[name] = torch.log(torch.arange(1, n + 1, device=device, dtype=torch.float32)
                                ).repeat(d, 1)
        elif name.endswith(".mixer.D") or name.endswith(".lsigmoid.slope"):
            w[name] = torch.ones_like(w[name])
        elif name.endswith(".mixer.dt_proj.bias"):
            u = torch.rand(w[name].shape, generator=g, device=device)
            dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN))
            dt = dt.clamp(min=DT_FLOOR)
            w[name] = dt + torch.log(-torch.expm1(-dt))
        for suffix, factor in SCALED.items():
            if name.endswith(suffix):
                w[name] = w[name] * factor
        if name == "dense_encoder.dense_conv_1.0.weight":
            w[name] = w[name] * torch.tensor([1.0, PHASE_IN], device=device)[None, :, None, None]
    return w


def build_model(config: dict, seed: int, device):
    """``(model, shapes)``: the port's model of ``config`` on ``device`` in
    eval mode with the seed's weights."""
    model = system.port("models").create_model(system.port_config(config)).to(device)
    shapes = weights.float_shapes(model)
    w = draw(shapes, seed, device)
    with torch.no_grad():
        state = model.state_dict()
        for name, t in w.items():
            state[name].copy_(t)
    return model.eval(), shapes


def fault_scan(kind: str):
    """The stand-in ``kind`` for the port's ``selective_scan`` (the module
    docstring), built from the real one."""
    real = system.port("ops.cuda_scan").selective_scan

    def reset64(u, delta, z, b, c, a_log, d, bias, n_valid=None, reverse=False):
        length, parts = u.shape[1], []
        for s in range(0, length, 64):
            e = min(s + 64, length)
            nv = None if n_valid is None else (n_valid - s).clamp(0, e - s).to(torch.int32)
            parts.append(real(*(t[:, s:e].contiguous() for t in (u, delta, z, b, c)), a_log, d,
                              bias, nv, reverse))
        return torch.cat(parts, dim=1)

    def from_end(u, delta, z, b, c, a_log, d, bias, n_valid=None, reverse=False):
        if not reverse or n_valid is None:
            return real(u, delta, z, b, c, a_log, d, bias, n_valid, reverse)
        y = real(u, delta, z, b, c, a_log, d, bias, None, True)
        steps = torch.arange(u.shape[1], device=u.device)[None, :]
        return y * (steps < n_valid[:, None]).to(y.dtype)[..., None]

    def forward_only(u, delta, z, b, c, a_log, d, bias, n_valid=None, reverse=False):
        return real(u, delta, z, b, c, a_log, d, bias, n_valid, False)

    return {"reset64": reset64, "reverse_from_end": from_end,
            "reverse_is_forward": forward_only}[kind]


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
    semamba = system.port("models.semamba")
    fault = p.get("fault", "none")
    if fault != "none":
        semamba.selective_scan = fault_scan(fault)
    with span("inputs"):
        batches = make_batches(ctx)
        floats = [[clips.to_float(c) for c in rows] for _, rows in batches]
    inference = system.port("inference")
    with span("build"):
        model, shapes = build_model(config, ctx.seed, dev)
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
        return (semamba_work.enhance_flops(config, len(rows), n, lens),
                semamba_work.scan_work(config, len(rows), n, lens),
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
        blocks = [s.end - s.start for s in tracing.spans() if s.name == "semamba.tfmamba"]
        ctx.facts.update(slice_flops=slice_flops, slice_s=ctx.tracer.t1 - ctx.tracer.t0,
                         traced_scan=[w for j in traced for w in work_of(j)[1]],
                         traced_dsp=[work_of(j)[2] for j in traced],
                         tfmamba_launch_ms=1e3 * sum(blocks) / len(traced) if blocks else None)
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
