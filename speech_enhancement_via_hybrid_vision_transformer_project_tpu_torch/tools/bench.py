"""Enhancement throughput (audio-seconds a second) on one card: the port's
``bench.py``.

The model is the JAX script's: ``create_hybrid_vit`` defaults with every
dropout 0, float32 (the JAX script rounds the input to bf16 on a TPU only;
here every layer computes in float32 and TF32 is off), weights drawn by
``init_weights`` from ``torch.Generator().manual_seed(0)``. The input is
the JAX script's: 32 clips of 3 s, a 220 Hz sine plus noise from
``np.random.default_rng(0)``.

Two legs, as in the JAX script:

- ``value``, end to end: 20 iterations of ``AudioEnhancer(io_dtype="int16")
  .enhance_batch_async`` with two batches in flight, host arrays in
  (quantized to PCM16, copied through pinned memory) and host arrays out.
- ``device_audio_s_per_s``, the same core on the card alone: each iteration
  synthesizes its batch on the device (``bench_stages.synthesize``) and runs
  the core on it (``bench_stages.run_prefix("full")``: K1, the forward with
  K2, K3), timed with CUDA events over 30 iterations after a warm-up.

``mfu_pct`` is the analytic FLOPs of that core step
(``flops.inference_step_flops``: the forward, the STFT and the iSTFT) over
its device time, over the card's data-sheet peak for the math mode in force
(``flops.peak_flops``: float32, 67 TFLOP/s on an H100 SXM), null where the
card has no entry. The script exits 1 when it reads above 100: that shows
the count or the window is wrong. ``vs_baseline`` is the realtime factor,
as in the JAX script (the reference states "near real-time" on a GPU).
``link_MBps_h2d`` and ``link_MBps_d2h`` are the host-card copy rates of a 4
MiB pageable buffer, median of 3. The line names the device, the card and
its power limit.

``--device cpu`` runs both legs once with the kernels' plain versions and
measures nothing: every time, rate and share is null.

Prints exactly ONE JSON line.

    python -m speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools.bench \\
        [--device cuda|cpu] [--batch 32] [--seconds 3.0] [--iters 20] [--device-iters 30]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import warnings

import numpy as np
import torch

from . import bench_stages
from .flops import describe_device, inference_step_flops, mfu_pct, spec_from_model

SR = 16000


def clips(batch: int, seconds: float) -> list:
    """The JAX script's input: ``batch`` clips of a 220 Hz sine at 0.3 plus
    0.05 white noise from ``np.random.default_rng(0)``."""
    n = int(SR * seconds)
    rng = np.random.default_rng(0)
    return [(0.3 * np.sin(2 * np.pi * 220 * np.arange(n) / SR)
             + 0.05 * rng.standard_normal(n)).astype(np.float32) for _ in range(batch)]


def link_rates(device: str, rng: np.random.Generator) -> tuple:
    """Median MB/s of 3 host-to-card and card-to-host copies of fresh 4 MiB
    int16 buffers."""
    nbytes = 4 * 1024 * 1024
    ups, downs = [], []
    for _ in range(3):
        host = torch.from_numpy(rng.integers(-32768, 32767, size=nbytes // 2, dtype=np.int16))
        t0 = time.perf_counter()
        dev = host.to(device)
        torch.cuda.synchronize()
        ups.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        dev.cpu()
        downs.append(time.perf_counter() - t0)
    return nbytes / 1e6 / statistics.median(ups), nbytes / 1e6 / statistics.median(downs)


def run(device: str, batch: int = 32, seconds: float = 3.0, iters: int = 20,
        device_iters: int = 30) -> dict:
    """Both legs; returns the JSON line's fields (the timings None on the
    CPU) and ``launches_per_step``, each kernel's launches a device step."""
    from ..inference import AudioEnhancer
    from ..ops import kernels
    from ..ops.stft import STFTConfig

    cuda = device == "cuda"
    model = bench_stages.build_model(device=device)
    wavs = clips(batch, seconds)
    with warnings.catch_warnings():  # the magnitude head at blend 1.0, as the JAX script serves it
        warnings.simplefilter("ignore", UserWarning)
        enhancer = AudioEnhancer(model, {}, device=device, io_dtype="int16")

    enhancer.enhance_batch(wavs)  # warm-up
    n = iters if cuda else 1
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = []
    for _ in range(n):  # two batches in flight, fresh host memory in and out
        pending.append(enhancer.enhance_batch_async(wavs))
        if len(pending) > 2:
            pending.pop(0).result()
    for p in pending:
        p.result()
    elapsed = time.perf_counter() - t0
    throughput = n * batch * seconds / elapsed if cuda else None

    # the same core on device-synthesized batches
    cfg = STFTConfig()
    frames = int(SR * seconds) // cfg.hop_length
    wav_len = frames * cfg.hop_length
    gen = torch.Generator(device=device).manual_seed(0)

    def step():
        return bench_stages.run_prefix("full", model, bench_stages.synthesize(gen, batch, wav_len),
                                       cfg)

    step()
    dev_ms = launches = None
    if cuda:
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        dev_ms = bench_stages.time_ms(step, device_iters, warmup=0)
        launches = {k: v.launches / device_iters for k, v in kernels.KERNELS.items()}
    flops = inference_step_flops(spec_from_model(model), batch, cfg.num_bins,
                                 cfg.num_frames(wav_len), cfg.n_fft)
    share = mfu_pct(flops, dev_ms and dev_ms * 1e-3)
    h2d = d2h = None
    if cuda:
        h2d, d2h = link_rates(device, np.random.default_rng(0))
    rnd = lambda v, k=2: None if v is None else round(v, k)  # noqa: E731
    return {
        "metric": "enhance_throughput_audio_seconds_per_s_per_chip",
        "value": rnd(throughput),
        "unit": "audio_s/s",
        "vs_baseline": rnd(throughput),
        "device_audio_s_per_s": rnd(dev_ms and batch * wav_len / SR / (dev_ms * 1e-3)),
        "device_step_ms": rnd(dev_ms, 3),
        "mfu_pct": rnd(share),
        "flops_per_step": flops,
        "link_MBps_h2d": rnd(h2d),
        "link_MBps_d2h": rnd(d2h),
        **describe_device(device),
        "launches_per_step": launches,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--iters", type=int, default=20, help="end-to-end iterations")
    ap.add_argument("--device-iters", type=int, default=30, help="device-leg iterations")
    args = ap.parse_args(argv)

    from ..cli._runtime import use_device

    use_device(args.device)
    line = run(args.device, args.batch, args.seconds, args.iters, args.device_iters)
    print(json.dumps(line))
    if line["mfu_pct"] is not None and line["mfu_pct"] > 100:
        print(f"mfu_pct {line['mfu_pct']} > 100: the FLOP count or the timed window is wrong",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
