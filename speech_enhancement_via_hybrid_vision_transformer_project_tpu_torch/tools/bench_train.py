"""Training-step throughput (the port's ``benchmarks/bench_train.py``, with
its flags but ``--prng``).

Measures the full train step of ``training.trainer.make_step_fns``:
featurize on the device (kernel K1 twice: noisy and clean) -> forward ->
loss -> backward -> global-norm clip -> AdamW (lr 1e-4, weight decay 0.01,
clip 1.0: the JAX script's ``chain_with_clip(create_optimizer({}), 1.0)``),
SpecAugment on, for a model size and batch shape; reports ms a step,
audio-seconds a second and the share of the card's data-sheet peak.

Each iteration synthesizes its batch on the device (noisy and clean
``N(0, 1)`` from a ``torch.Generator(device="cuda")``, every row valid, at
``(frames - 1) * hop`` samples); CUDA events time ``--iters`` steps after a
warm-up. The step's own non-finite check reads one value back to the host
each step, as in training.

With attention dropout 0 attention runs through kernel K2 and its gradient
through K2's backward, 6 times a step each at 28M; ``--attention pallas``
forces attention dropout 0 unless ``--dropout`` is given, as the JAX script
does (``benchmarks/bench_train.py:112-117``); ``--attention xla`` takes the
plain version on the card too. With attention dropout > 0 (the model's
default, 0.1) the model takes the explicit-weights path and no K2 runs.

The FLOPs a step are the analytic ``flops.train_step_flops`` (featurize,
3x the forward, AdamW), and beside them PyTorch's own count of one step
(``flops.torch_program_flops``, in place of the JAX script's XLA count),
which also counts the losses' DFTs and leaves out the bilinear resizes.
The launches of each kernel a step come from the kernels' counters.

``--prng`` of the JAX script picks a JAX PRNG implementation: it has no
counterpart here (dropout and SpecAugment draw from ``torch.Generator``s).
``--device cpu`` runs one step with the plain versions and measures
nothing.

    python -m speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools.bench_train \\
        [--scaled] [--head resize|fullres_mask] [--batch 16] [--frames 256] [--iters 30]
        [--device cuda|cpu] [--fp32] [--attention auto|pallas|xla] [--dropout P] [--remat]
        [--output-mode magnitude|mask]
"""

from __future__ import annotations

import argparse

import torch

from . import bench_infer, bench_stages
from .flops import (
    card_line,
    describe_device,
    mfu_pct,
    mfu_report,
    spec_from_model,
    torch_program_flops,
    train_step_flops,
)


def build(args):
    """The model of ``args`` (seeded weights), on ``args.device``, and its
    train step."""
    from ..data.augmentation import SpecAugmentConfig
    from ..models import create_hybrid_vit, init_weights
    from ..ops.stft import STFTConfig
    from ..training.losses import LossConfig
    from ..training.optimizer import Optimizer, parameters
    from ..training.trainer import make_step_fns

    overrides = dict(compute_dtype=torch.float32 if args.fp32 else torch.bfloat16,
                     remat=args.remat, head_type=args.head)
    if args.scaled:
        overrides.update(embed_dim=1024, num_heads=16, num_layers=12)
    if args.dropout is not None:
        overrides.update(dropout=args.dropout, attn_dropout=args.dropout,
                         drop_path_rate=args.dropout)
    if args.attention == "pallas" and args.dropout is None:
        # attention dropout takes the explicit-weights path: zero it so that
        # kernel K2 runs
        overrides.update(attn_dropout=0.0)
    model = init_weights(create_hybrid_vit(**overrides), torch.Generator().manual_seed(0))
    model = bench_infer.use_attention(model.to(args.device), args.attention)
    torch.manual_seed(0)  # dropout's draws
    opt = Optimizer(parameters(model), "adamw", lr=1e-4, weight_decay=0.01, max_norm=1.0)
    step, _ = make_step_fns(model, opt, LossConfig(), STFTConfig(), SpecAugmentConfig(),
                            output_mode=args.output_mode,
                            generator=torch.Generator(device=args.device).manual_seed(1))
    return model, step


def measure(args) -> dict:
    """The step's analytic and counted FLOPs and, on the card, its ms,
    audio-s/s, share of the peak and launches a step."""
    from ..models import count_parameters
    from ..ops import kernels
    from ..ops.stft import STFTConfig

    model, train_step = build(args)
    b, t = args.batch, args.frames
    wav_len = (t - 1) * STFTConfig().hop_length
    gen = torch.Generator(device=args.device).manual_seed(2)

    def step():
        return train_step({
            "noisy_audio": torch.randn(b, wav_len, generator=gen, device=args.device),
            "clean_audio": torch.randn(b, wav_len, generator=gen, device=args.device),
            "length": torch.full((b,), wav_len, dtype=torch.int32, device=args.device),
            "valid": torch.ones(b, dtype=torch.bool, device=args.device),
        })

    n_params = count_parameters(model)["total"]
    analytic = train_step_flops(spec_from_model(model), b, 257, t, n_params=n_params)
    metrics = step()  # first step
    counted = torch_program_flops(step)
    out = {"params": n_params, "analytic": analytic, "torch_flops": counted,
           "loss": float(metrics["total"]), "step_ms": None, "audio_s_per_s": None,
           "mfu_pct": None, "launches_per_step": None}
    if args.device != "cuda":
        return out
    step()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    ms = bench_stages.time_ms(step, args.iters, warmup=0)
    out.update(step_ms=ms, audio_s_per_s=b * wav_len / 16000 / (ms * 1e-3),
               mfu_pct=mfu_pct(analytic["train_total"], ms * 1e-3),
               launches_per_step={k: v.launches / args.iters for k, v in kernels.KERNELS.items()})
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="The JAX script's --prng (a JAX PRNG implementation) has no counterpart: "
               "dropout and SpecAugment draw from torch.Generators.")
    ap.add_argument("--head", default="resize", choices=["resize", "fullres_mask"],
                    help="output head (fullres_mask = the quality recipe's)")
    ap.add_argument("--scaled", action="store_true", help="12L/1024d/16h stress config")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--fp32", action="store_true",
                    help="float32 input (default: rounded to bf16, the JAX package's "
                         "compute_dtype; every layer computes in float32 either way)")
    ap.add_argument("--attention", default="auto", choices=["auto", "pallas", "xla"],
                    help="pallas: kernel K2 (attention dropout 0 unless --dropout); xla: "
                         "its plain version; auto: the model's default")
    ap.add_argument("--dropout", type=float, default=None,
                    help="override dropout+attn_dropout+drop_path (attn_dropout>0 takes the "
                         "explicit-weights path)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute the transformer blocks in the backward")
    ap.add_argument("--output-mode", default="magnitude", choices=["magnitude", "mask"],
                    help="train-step head semantics (mask = the quality recipe's)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    from ..cli._runtime import use_device

    use_device(args.device)
    res = measure(args)
    an = res["analytic"]
    print(f"model: {res['params'] / 1e6:.2f}M params  "
          f"dtype={'float32' if args.fp32 else 'bfloat16'}  batch={args.batch} x "
          f"{args.frames} frames  attention {args.attention}")
    ms = res["step_ms"]
    if ms is None:
        print(f"train step: not measured (cpu); first step's loss {res['loss']:.4f}")
    else:
        print(f"train step: {ms:.2f} ms  throughput: {res['audio_s_per_s']:,.0f} audio-s/s  "
              f"steps/s: {1e3 / ms:,.1f}")
    print(f"FLOPs/step: analytic {an['train_total'] / 1e9:.1f} GF (featurize "
          f"{an['featurize'] / 1e9:.1f} + 3x fwd {an['forward'] / 1e9:.1f})  torch "
          f"{res['torch_flops'] / 1e9:.1f} GF")
    print("MFU: " + mfu_report(an["train_total"], ms and ms * 1e-3))
    if res["launches_per_step"] is not None:
        print(f"launches a step: {res['launches_per_step']}")
    print(card_line(describe_device(args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
