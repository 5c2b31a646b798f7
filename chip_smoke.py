"""Drive the PyTorch port's serving path once on a CUDA card and check it.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout (it imports the
port package beside this file); it imports nothing of JAX. Phases, each of
which raises on failure:

1. device: a CUDA card is required; prints its name and power limit and
   turns TF32 off (float32 end to end).
2. build: compiles the three kernels from the port's ``csrc/``, one nvcc
   per source, all started together; prints K2's registers, shared memory
   and blocks per SM, and checks that its code holds TF32 tensor-core
   instructions (``HMMA ... TF32`` in ``cuobjdump -sass``).
3. kernels: each kernel against its plain PyTorch version at the serving
   path's shapes (batch 32 x 3 s; attention under the serving batch's own
   mask and under a mix of clip lengths) and at ragged shapes (attention: a
   fully masked row, a row keeping one key), max errors within the stated
   tolerances.
4. trained weights: the ``tests/fixtures/tiny_denoiser_mask`` checkpoint,
   read by the port's msgpack reader, enhances two synthetic clips on
   cuda and on cpu; the waveforms agree.
5. full width: the 28M configuration (embed 512, 8 heads, 6 layers) with
   the serving recipe (factored_2d, mask output, fullres_mask head,
   mask_padding), seeded random weights, enhances 32 x 3 s PCM16 on cuda;
   the output is finite, of the right shape, matches a cpu run on a short
   clip, and went through all three kernels.
6. serving: the HTTP server around that enhancer answers 6 concurrent
   requests, each equal to a direct ``enhance``.
7. times: each kernel against its plain version and its one-call PyTorch
   yardstick (``torch.stft``, ``scaled_dot_product_attention``,
   ``torch.istft``; the port never calls these), per-call CUDA-event times
   over fresh inputs and the device time alone (``torch.profiler``),
   beside its bound: the larger of its operations over the peak rate of
   their route (the FFTs: fp32; attention: 3xTF32 on the tensor cores) and
   its bytes over the memory rate. K2's inputs carry the mask of the
   slice's own batch (32 clips of 3 s, which keep every key); K2 is also
   timed under a mix of clip lengths (1 to 3.06 s, a third of the keys
   masked) and with no mask. Then the slice's audio-seconds per second at
   batch 32 x 3 s, and each kernel's device time per launch in one
   profiled batch.

Prints, on its last three lines: the card's ``nvidia-smi`` name and power
limit, a JSON line of per-kernel results, and the result JSON.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SR = 16000
BATCH, SECONDS = 32, 3.0
# tolerances (max abs error), with their reasons
TOL_STFT = 2e-3  # the plain version's fp32 DFT sums of 512 terms of |x|<~5 vs an fp32 FFT
TOL_ATTN = 2e-5  # fp32 softmax(QK^T)V, online vs two-pass softmax
TOL_ISTFT = 2e-5  # fp32 inverse DFT vs inverse FFT, overlap-add in another order
TOL_WAVE = 2e-4  # waveform through ~20 fp32 layers on two devices (~6 PCM16 LSB)
# H100 SXM peaks at the 700 W limit (NVIDIA data sheet): fp32 outside the
# tensor cores, and HBM3
FP32_PEAK = 67e12  # FLOP/s
HBM_RATE = 3.35e12  # bytes/s
# fp32-accurate matrix products on the tensor cores: 3xTF32, three dense
# TF32 products (495 TFLOP/s) per fp32 product. The fastest route to fp32
# accuracy for a matrix product on this card, and the one both K2 and its
# SDPA yardstick (PyTorch's memory-efficient kernel) take.
TF32X3_PEAK = 495e12 / 3  # FLOP/s


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def speechlike(n: int, rng: np.random.Generator) -> np.ndarray:
    """Harmonic tone with a syllable-rate envelope plus white noise."""
    t = np.arange(n) / SR
    f0 = rng.uniform(100, 250)
    x = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.28)) / h for h in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2, 5) * t))
    x = 0.3 * env * x / np.max(np.abs(x)) + 0.05 * rng.standard_normal(n)
    return x.astype(np.float32)


def median_ms(fn, inputs, reps: int = 5) -> float:
    """Per-call time of ``fn``: CUDA events around ``fn(*args)`` for every
    argument tuple of ``inputs`` back to back (fresh data each call: the
    tuples together exceed the 50 MB L2), divided by their number; the
    median of ``reps`` such runs, after one warm-up run."""
    for args in inputs:
        fn(*args)
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for args in inputs:
            fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(inputs))
    return statistics.median(times)


def device_times(run, attempts: int = 3) -> dict[str, float]:
    """Device time (ms) of every CUDA kernel and copy ``run()`` enqueues,
    summed by name, as ``torch.profiler`` records it. Now and then the
    profiler hands back an empty trace; then ``run()`` is profiled again,
    up to ``attempts`` times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        times = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA}
        if sum(times.values()) > 0:
            return times
    raise RuntimeError(f"the profiler recorded no device time in {attempts} runs")


def device_ms(fn, inputs) -> float:
    """Per-call device time of ``fn`` over one call per argument tuple of
    ``inputs``, after one warm-up call each. Unlike ``median_ms`` it leaves
    out the host's launch cost."""
    for args in inputs:
        fn(*args)

    def run():
        for args in inputs:
            fn(*args)

    return sum(device_times(run).values()) / len(inputs)


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of ``flops`` over
    ``peak`` and ``nbytes`` over the memory rate, and which binds."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def rfft_flops(n: int) -> float:
    """Operations of one real FFT of ``n`` points (half a complex one's
    5 n log2 n)."""
    return 2.5 * n * np.log2(n)


def max_err(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def main() -> int:
    phase("device")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs one CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, card: {smi}", flush=True)
    # float32 end to end: cuDNN convolutions would otherwise run in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.wavio import (
        read_wav_bytes, wav_bytes,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
        AudioEnhancer, make_server,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
        HybridViT, create_hybrid_vit, init_weights,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models.components import (
        patch_validity_mask,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_attention, cuda_stft, kernels,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import STFTConfig
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
        load_model_weights, read_meta,
    )

    phase("build")
    t0 = time.perf_counter()
    libs = kernels.build()
    print(f"built {sorted(p.name for p in libs.values())} from csrc/*.cu (one nvcc each, "
          f"in parallel) in {time.perf_counter() - t0:.1f} s", flush=True)
    for d in (64, 128):
        print(f"attention_fwd at head dim {d}, 384 keys, masked: "
              f"{cuda_attention.kernel_info(d, 384)}", flush=True)
    cuobjdump = shutil.which("cuobjdump") or str(Path(kernels._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(libs["attention_fwd"])],
                          capture_output=True, text=True, check=True).stdout
    hmma = [line.split(";")[0].split("*/")[-1].strip() for line in sass.splitlines()
            if "HMMA" in line and "TF32" in line]
    if not hmma:
        raise AssertionError("attention_fwd's SASS holds no TF32 tensor-core instruction")
    print(f"attention_fwd SASS: {len(hmma)} TF32 tensor-core instructions "
          f"({sorted(set(i.split()[0] for i in hmma))}, e.g. {hmma[0]!r})", flush=True)

    phase("kernels vs plain")
    cfg = STFTConfig()
    g = torch.Generator().manual_seed(0)
    wav_len = int(SECONDS * SR) + 1024  # 49024 = (384-1)*128: the 3 s bucket
    n_frames, heads, n_tok, dh = 384, 8, 16 * 24, 64
    errs = {}
    # the main path's shape, a ragged length, and one shorter than a frame
    # whose reflect padding reaches both ends
    for shape in ((BATCH, wav_len), (1, 5123), (2, 300)):
        x = torch.randn(shape, generator=g).to(dev)
        errs.setdefault("stft_mag", []).append(
            max_err(cuda_stft.stft_mag(x, cfg), cuda_stft.stft_mag_plain(x, cfg)))
    # the serving batch's mask (32 clips of 3 s keep every key), and one of
    # clip lengths spread evenly from 1 to 3.06 s (a third of the keys masked)
    serve_mask = patch_validity_mask(torch.full((BATCH,), int(SECONDS * SR)), 257, n_frames,
                                     cfg.hop_length).to(dev)
    lengths = torch.from_numpy(np.linspace(SR, wav_len, BATCH).astype(np.int64))
    mix_mask = patch_validity_mask(lengths, 257, n_frames, cfg.hop_length).to(dev)
    ragged_mask = torch.rand(4, 200, generator=g) > 0.3
    ragged_mask[0] = False  # a row with every key masked
    single_mask = torch.rand(3, 37, generator=g) > 0.3
    single_mask[1] = False
    single_mask[1, 20] = True  # a row keeping a single key
    for (b, n, mask) in ((BATCH, n_tok, serve_mask), (BATCH, n_tok, mix_mask),
                         (4, 200, ragged_mask.to(dev)), (3, 37, single_mask.to(dev))):
        q, k, v = (torch.randn(b, heads, n, dh, generator=g).to(dev) for _ in range(3))
        errs.setdefault("attention_fwd", []).append(max_err(
            [cuda_attention.attention(q, k, v, scale=dh**-0.5, mask=mask)],
            [cuda_attention.attention_plain(q, k, v, scale=dh**-0.5, mask=mask)]))
    for (b, nf, length) in ((BATCH, n_frames, wav_len), (2, 376, 48000)):
        mag = torch.rand(b, 257, nf, generator=g).to(dev)
        ph = (torch.rand(b, 257, nf, generator=g) * 2 * np.pi - np.pi).to(dev)
        errs.setdefault("istft_polar", []).append(max_err(
            [cuda_stft.istft_polar(mag, ph, cfg, length=length)],
            [cuda_stft.istft_polar_plain(mag, ph, cfg, length=length)]))
    torch.cuda.synchronize()
    tols = {"stft_mag": TOL_STFT, "attention_fwd": TOL_ATTN, "istft_polar": TOL_ISTFT}
    for name, e in errs.items():
        print(f"{name}: max abs err {e} (tolerance {tols[name]})", flush=True)
        if max(e) > tols[name]:
            raise AssertionError(f"{name} disagrees with its plain version: {e}")

    phase("trained weights: fixture on cuda vs cpu")
    fixture = ROOT / "tests" / "fixtures" / "tiny_denoiser_mask"
    fx_cfg = read_meta(fixture)["config"]
    rng = np.random.default_rng(7)
    clips = [speechlike(int(1.3 * SR), rng), speechlike(int(2.2 * SR), rng)]
    outs = {}
    for device in ("cuda", "cpu"):
        model = load_model_weights(fixture, HybridViT(**fx_cfg["tiny"]))
        enh = AudioEnhancer(model, fx_cfg, device=device, mask_padding=True)
        outs[device] = enh.enhance_batch(clips)
    for a, b in zip(outs["cuda"], outs["cpu"]):
        if a.shape != b.shape or not np.isfinite(a).all():
            raise AssertionError("fixture output malformed")
    fx_err = max(float(np.abs(a - b).max()) for a, b in zip(outs["cuda"], outs["cpu"]))
    print(f"fixture waveforms cuda vs cpu: max abs err {fx_err:.3g} (tolerance {TOL_WAVE})", flush=True)
    if fx_err > TOL_WAVE:
        raise AssertionError("fixture enhancement differs between cuda and cpu")

    phase("full width: 28M serving recipe, 32 x 3 s PCM16 on cuda")
    config = {"model": {"output_mode": "mask", "head": "fullres_mask",
                        "transformer": {"pos_embed": "factored_2d"}}}
    model = init_weights(create_hybrid_vit(config), torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    short = speechlike(SR, rng)
    ref_short = AudioEnhancer(model, config, device="cpu", io_dtype="int16",
                              mask_padding=True).enhance(short)
    enhancer = AudioEnhancer(model, config, device=dev, io_dtype="int16", mask_padding=True)
    wavs = [speechlike(int(SECONDS * SR), rng) for _ in range(BATCH)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = enhancer.enhance_batch(wavs)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    print(f"{n_params / 1e6:.2f}M parameters; launches in the batch: {launches}", flush=True)
    if len(out) != BATCH or any(o.shape != w.shape or not np.isfinite(o).all()
                                for o, w in zip(out, wavs)):
        raise AssertionError("full-width output malformed")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path did not run: {launches}")
    short_err = float(np.abs(enhancer.enhance(short) - ref_short).max())
    print(f"full width 1 s clip cuda vs cpu: max abs err {short_err:.3g} "
          f"(tolerance {TOL_WAVE})", flush=True)
    if short_err > TOL_WAVE:
        raise AssertionError("full-width enhancement differs between cuda and cpu")

    phase("serving: 6 concurrent HTTP requests")
    server = make_server(enhancer, port=0, max_batch=BATCH, max_wait_ms=50.0)
    serve_thread = threading.Thread(target=server.serve_forever, daemon=True)
    serve_thread.start()
    try:
        url = "http://%s:%d" % server.server_address[:2]
        reqs = [speechlike(int(s * SR), rng) for s in (1.0, 1.4, 1.8, 2.2, 2.6, 3.0)]
        results = [None] * len(reqs)
        kernels.reset_launch_counts()

        def post(i):
            r = urllib.request.urlopen(urllib.request.Request(
                f"{url}/enhance", data=wav_bytes(reqs[i], SR, subtype="float32")), timeout=300)
            results[i] = (r.status, read_wav_bytes(r.read(), SR)[0])

        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads) or any(r is None or r[0] != 200 for r in results):
            raise AssertionError(f"HTTP requests failed: {[r and r[0] for r in results]}")
        served = {name: k.launches for name, k in kernels.KERNELS.items()}
        stats = json.loads(urllib.request.urlopen(f"{url}/stats", timeout=30).read())
        http_err = max(float(np.abs(r[1] - enhancer.enhance(w)).max())
                       for r, w in zip(results, reqs))
        print(f"served 6 requests in {stats['batches']} batches; max abs err vs direct "
              f"enhance {http_err:.3g}; launches {served}", flush=True)
        if stats["requests"] != 6 or http_err > TOL_WAVE or min(served.values()) < 1:
            raise AssertionError(f"serving check failed: {stats}, err {http_err}, {served}")
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        serve_thread.join(timeout=10)

    phase("times")
    n_fresh = 8
    xs = [(torch.randn(BATCH, wav_len, generator=g).to(dev), cfg) for _ in range(n_fresh)]
    qkv = [tuple(torch.randn(BATCH, heads, n_tok, dh, generator=g).to(dev) for _ in range(3))
           for _ in range(n_fresh)]
    mp = [(torch.rand(BATCH, 257, n_frames, generator=g).to(dev),
           (torch.rand(BATCH, 257, n_frames, generator=g) * 6.28 - 3.14).to(dev))
          for _ in range(n_fresh)]
    win = torch.from_numpy(cfg.padded_window()).to(dev)
    key_mask = serve_mask[:, None, None, :]
    timed = {  # name: (kernel, plain version, one-call library yardstick, inputs)
        "stft_mag": (
            cuda_stft.stft_mag, cuda_stft.stft_mag_plain,
            lambda x, c: torch.stft(x, c.n_fft, c.hop_length, window=win, center=True,
                                    pad_mode="reflect", return_complex=True).abs(),
            xs),
        "attention_fwd": (
            lambda q, k, v: cuda_attention.attention(q, k, v, scale=dh**-0.5, mask=serve_mask),
            lambda q, k, v: cuda_attention.attention_plain(q, k, v, scale=dh**-0.5, mask=serve_mask),
            lambda q, k, v: F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask,
                                                           scale=dh**-0.5),
            qkv),
        "istft_polar": (
            lambda m, p: cuda_stft.istft_polar(m, p, cfg, length=wav_len),
            lambda m, p: cuda_stft.istft_polar_plain(m, p, cfg, length=wav_len),
            lambda m, p: torch.istft(torch.polar(m, p), cfg.n_fft, cfg.hop_length, window=win,
                                     center=True, length=wav_len),
            mp),
    }
    # operations and bytes each function must do and move on these inputs:
    # every input read once, every output written once; attention counts the
    # keys the mask keeps, since a masked key adds nothing to the output
    n_bins, frames = cfg.num_bins, BATCH * n_frames
    kept_keys = int(serve_mask.sum())
    work = {
        "stft_mag": (frames * (rfft_flops(cfg.n_fft) + cfg.n_fft + 4 * n_bins),
                     4 * (BATCH * wav_len + 3 * BATCH * n_bins * n_frames)),
        "attention_fwd": (4 * heads * n_tok * dh * kept_keys,
                          4 * 4 * BATCH * heads * n_tok * dh + BATCH * n_tok),
        "istft_polar": (frames * (rfft_flops(cfg.n_fft) + 2 * n_bins + 2 * cfg.n_fft)
                        + BATCH * wav_len,
                        4 * (2 * BATCH * n_bins * n_frames + BATCH * wav_len)),
    }
    peaks = {"stft_mag": FP32_PEAK, "attention_fwd": TF32X3_PEAK, "istft_polar": FP32_PEAK}
    ms = {}
    for name, (kern, plain, lib_call, inputs) in timed.items():
        # plain, kernel, library, library, kernel, plain: each one's better median
        p1, k1, l1, l2, k2, p2 = (median_ms(f, inputs)
                                  for f in (plain, kern, lib_call, lib_call, kern, plain))
        flops, nbytes = work[name]
        b_ms, b_by = bound(flops, nbytes, peaks[name])
        ms[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": min(l1, l2),
                    "bound_ms": b_ms, "bound_by": b_by, "device_ms": device_ms(kern, inputs)}
        m = ms[name]
        print(f"{name}: per call {m['ms']:.4f} ms (device {m['device_ms']:.4f}), plain "
              f"{m['plain_ms']:.4f} ms (device {device_ms(plain, inputs):.4f}), library "
              f"{m['library_ms']:.4f} ms (device {device_ms(lib_call, inputs):.4f}); bound "
              f"{b_ms:.4f} ms by {b_by} ({flops / 1e9:.3f} GFLOP at {peaks[name] / 1e12:g} "
              f"TFLOP/s, {nbytes / 1e6:.2f} MB at {HBM_RATE / 1e12:g} TB/s); share of "
              f"bound {b_ms / m['ms']:.1%} per call, {b_ms / m['device_ms']:.1%} on the device; "
              f"device rates {flops / (m['device_ms'] * 1e-3) / 1e12:.2f} TFLOP/s, "
              f"{nbytes / (m['device_ms'] * 1e-3) / 1e12:.2f} TB/s (per call: median of 5 runs "
              f"over {n_fresh} fresh inputs; device: mean over them; {smi})", flush=True)
    # K2 under the length mix's mask (it walks only the kept keys) and with
    # no mask (every key): in turns, each one's better median and device time
    mixed, unmasked = (
        lambda q, k, v, m=m: cuda_attention.attention(q, k, v, scale=dh**-0.5, mask=m)
        for m in (mix_mask, None))
    m1, u1, u2, m2 = (median_ms(f, qkv) for f in (mixed, unmasked, unmasked, mixed))
    print(f"attention_fwd under the length mix's mask ({int(mix_mask.sum())} of "
          f"{BATCH * n_tok} keys kept): per call {min(m1, m2):.4f} ms (device "
          f"{device_ms(mixed, qkv):.4f}); no mask: per call {min(u1, u2):.4f} ms (device "
          f"{device_ms(unmasked, qkv):.4f}); {smi}", flush=True)
    walls = []
    for _ in range(5):
        batch = [speechlike(int(SECONDS * SR), rng) for _ in range(BATCH)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enhancer.enhance_batch(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(f"slice: enhance_batch of {BATCH} x {SECONDS:g} s PCM16 in {wall * 1e3:.1f} ms "
          f"(median of 5) = {BATCH * SECONDS / wall:.1f} audio-s/s; {smi}", flush=True)
    times = device_times(lambda: enhancer.enhance_batch(batch))
    in_kernels = {name: sum(t for key, t in times.items() if f"{name}_kernel" in key)
                  for name in kernels.KERNELS}
    for name, t in in_kernels.items():
        ms[name]["path_device_ms"] = t / launches[name]
    print(f"slice device time (profiler, one batch): busy {sum(times.values()):.2f} ms; "
          f"hand-written kernels {({n: round(t, 4) for n, t in in_kernels.items()})} ms, per "
          f"launch {({n: round(m['path_device_ms'], 4) for n, m in ms.items()})} ms; {smi}",
          flush=True)

    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": str(Path(
            "speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch") / k.source),
         "replaces": k.replaces, "launches": launches[name], "max_abs_err": max(errs[name]),
         **ms[name]}
        for name, k in kernels.KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
