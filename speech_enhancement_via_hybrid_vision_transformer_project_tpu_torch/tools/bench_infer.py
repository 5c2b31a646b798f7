"""On-device inference throughput of the enhancement core (the port's
``benchmarks/bench_infer.py``, with its flags).

Measures the core: peak normalize -> STFT (kernel K1) -> HybridViT forward
(attention through kernel K2) -> phase-reuse iSTFT (kernel K3), excluding
the host's copies (``tools.bench`` measures the end-to-end path). Each
iteration synthesizes its batch on the device from a
``torch.Generator(device="cuda")`` and runs the core on it
(``bench_stages.synthesize`` and ``run_prefix("full")``); CUDA events time
``--iters`` iterations after a warm-up.

It prints the step's ms and audio-seconds per second, the analytic FLOPs a
step (``flops.inference_step_flops``: the forward, the STFT and the iSTFT)
beside PyTorch's own count of one step (``flops.torch_program_flops``), the
share of the card's data-sheet peak (``flops.mfu_report``), the card's name
and power limit, and the launches of K1, K2 and K3 a step from the kernels'
counters (1 / 6 / 1 at 28M).

``--attention`` is the caller's choice of attention: ``pallas`` kernel K2,
``xla`` its plain version on the card too, ``auto`` the model's default
(K2 on the card). ``--dft-precision`` is accepted for the JAX script's
flag: the port's iSTFT computes in float32 whatever it is (K3 is a float32
FFT), as ``AudioEnhancer``'s ``dft_precision``. ``--device cpu`` runs the
plain versions once and measures nothing.

    python -m speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools.bench_infer \\
        [--batch 32] [--seconds 3.0] [--scaled] [--head resize|fullres_mask]
        [--attention auto|pallas|xla] [--iters 30] [--device cuda|cpu] [--fp32] [--fold-bn]
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from . import bench_stages
from .flops import (
    card_line,
    describe_device,
    inference_step_flops,
    mfu_pct,
    mfu_report,
    spec_from_model,
    torch_program_flops,
)


def use_attention(model, choice: str):
    """``--attention``: ``xla`` sets every attention block to its plain
    version, ``pallas`` to kernel K2, ``auto`` leaves the model's default."""
    from ..models import MultiHeadSelfAttention

    if choice != "auto":
        for m in model.modules():
            if isinstance(m, MultiHeadSelfAttention):
                m.plain = choice == "xla"
    return model


def measure(model, device: str, batch: int, wav_len: int, iters: int, cfg) -> dict:
    """One core step's FLOPs (analytic and PyTorch's count) and, on the
    card, its ms, audio-s/s, share of the peak and launches a step (None on
    the CPU, where the step runs once)."""
    from ..ops import kernels

    gen = torch.Generator(device=device).manual_seed(0)

    def step():
        return bench_stages.run_prefix("full", model, bench_stages.synthesize(gen, batch, wav_len),
                                       cfg)

    frames = cfg.num_frames(wav_len)
    analytic = inference_step_flops(spec_from_model(model), batch, cfg.num_bins, frames,
                                    cfg.n_fft)
    counted = torch_program_flops(step)
    out = {"batch": batch, "wav_len": wav_len, "frames": frames, "analytic_flops": analytic,
           "torch_flops": counted, "step_ms": None, "audio_s_per_s": None, "mfu_pct": None,
           "launches_per_step": None}
    if device != "cuda":
        return out
    for _ in range(3):  # warm-up
        step()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    ms = bench_stages.time_ms(step, iters, warmup=0)
    out.update(step_ms=ms, audio_s_per_s=batch * wav_len / bench_stages.SR / (ms * 1e-3),
               mfu_pct=mfu_pct(analytic, ms * 1e-3),
               launches_per_step={k: v.launches / iters for k, v in kernels.KERNELS.items()})
    return out


def report(res: dict, info: dict) -> None:
    ms: Optional[float] = res["step_ms"]
    if ms is None:
        print("inference step: not measured (cpu)")
    else:
        print(f"inference step: {ms:.2f} ms  throughput: {res['audio_s_per_s']:,.0f} audio-s/s "
              "on device")
    print(f"FLOPs/step: analytic {res['analytic_flops'] / 1e9:.1f} GF, torch "
          f"{res['torch_flops'] / 1e9:.1f} GF (analytic/torch "
          f"{res['analytic_flops'] / res['torch_flops']:.4f})   MFU: "
          + mfu_report(res["analytic_flops"], ms and ms * 1e-3))
    if res["launches_per_step"] is not None:
        print(f"launches a step: {res['launches_per_step']}")
    print(card_line(info))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--head", default="resize", choices=["resize", "fullres_mask"],
                    help="output head (fullres_mask = the quality recipe's, +10-14%% forward "
                         "FLOPs at 3 s)")
    ap.add_argument("--scaled", action="store_true", help="12L/1024d/16h stress config")
    ap.add_argument("--attention", default="auto", choices=["auto", "pallas", "xla"],
                    help="pallas: kernel K2; xla: its plain version; auto: the model's "
                         "default (K2 on the card)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--fp32", action="store_true",
                    help="float32 input (default: rounded to bf16, the JAX package's "
                         "compute_dtype; every layer computes in float32 either way)")
    ap.add_argument("--fold-bn", action="store_true",
                    help="fold eval-mode BatchNorm into the conv weights before timing")
    ap.add_argument("--dft-precision", default="highest", choices=["highest", "high", "default"],
                    help="accepted for the JAX flag: the iSTFT computes in float32 "
                         "whatever it is")
    args = ap.parse_args(argv)

    from ..cli._runtime import use_device
    from ..models import count_parameters, fold_batchnorm
    from ..ops.stft import STFTConfig

    use_device(args.device)
    cfg = STFTConfig()
    model = bench_stages.build_model(head=args.head, scaled=args.scaled, fp32=args.fp32,
                                     device=args.device)
    b, wav_len = bench_stages.batch_shape(args.batch, args.seconds, cfg.hop_length)
    print(f"model: {count_parameters(model)['total'] / 1e6:.2f}M params  "
          f"dtype={'float32' if args.fp32 else 'bfloat16'}  batch={b} x {wav_len / 16000:.2f}s  "
          f"attention {args.attention}")
    if args.fold_bn:
        model = fold_batchnorm(model)
        print("BatchNorm folded into conv weights")
    use_attention(model, args.attention)
    report(measure(model, args.device, b, wav_len, args.iters, cfg), describe_device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
