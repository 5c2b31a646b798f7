"""Enhancement CLI (JAX ``cli/enhance.py``): one file, one file through
chunked streaming, or a directory in padded batches, on a CUDA card (or
the CPU).

    python -m speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli.enhance \\
        --checkpoint ckpt/best_model --input noisy_dir --output enhanced_dir

The model's architecture, audio and output mode come from the checkpoint's
``meta.json``. On ``--device cuda`` the STFT, attention and iSTFT kernels
are built from ``csrc/`` with nvcc at the first batch.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ._blendargs import add_blend_args, blend_kwargs
from ._runtime import caller_config, data_parallel_mesh, use_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Enhance noisy speech (PyTorch)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--config-dir", default="config")
    p.add_argument("--input", required=True, help="wav file or directory")
    p.add_argument("--output", required=True, help="wav file or directory")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--streaming", action="store_true",
                   help="chunked overlap-add mode for long audio")
    p.add_argument("--chunk-seconds", type=float, default=2.0)
    p.add_argument("--overlap-seconds", type=float, default=0.25)
    p.add_argument("--exact", action="store_true",
                   help="process at exact length (reference-parity mode)")
    p.add_argument("--io-dtype", default="float32", choices=["float32", "int16"],
                   help="host<->device transfer width (int16 halves it)")
    p.add_argument("--data-parallel", type=int, default=1,
                   help="replicas to split each batch's rows over: cuda:0..N-1, "
                        "or N on the CPU")
    p.add_argument("--fold-bn", action="store_true",
                   help="fold eval-mode BatchNorm into the conv weights (equal "
                        "output to fp32 rounding)")
    p.add_argument("--dft-precision", default="highest",
                   choices=["highest", "high", "default"],
                   help="iDFT precision the JAX package's reconstruction matmul may "
                        "use; 'high' and 'default' permit less precision and do not "
                        "demand it: here the reconstruction (K3 on the card, a float32 "
                        "matmul on the CPU) is float32 whatever is set")
    add_blend_args(p)
    p.add_argument("--mask-padding", action="store_true",
                   help="exclude bucket-padding patches from attention via "
                        "the model's key-padding mask (bucketed mode only)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    inp, out = Path(args.input), Path(args.output)
    if not inp.exists():
        raise SystemExit(f"input not found: {inp}")
    if inp.is_dir() and out.suffix:
        raise SystemExit("directory input requires a directory output")
    use_device(args.device)
    mesh = data_parallel_mesh(args.data_parallel, args.device)

    from ..data.wavio import load_audio, save_wav
    from ..inference import AudioEnhancer, load_model_for_inference

    model, config = load_model_for_inference(args.checkpoint, caller_config(args.config_dir),
                                             device=args.device)
    enhancer = AudioEnhancer(
        model, config, device=args.device, io_dtype=args.io_dtype,
        mask_padding=args.mask_padding, fold_bn=args.fold_bn, dft_precision=args.dft_precision,
        mesh=mesh, **blend_kwargs(args),
    )
    sr = enhancer.sample_rate
    if inp.is_dir():
        n = enhancer.enhance_directory(inp, out, batch_size=args.batch_size)
        print(f"enhanced {n} files -> {out}")
    else:
        audio, _ = load_audio(inp, sr)
        if args.streaming:
            enhanced = enhancer.enhance_streaming(audio, args.chunk_seconds, args.overlap_seconds)
        else:
            enhanced = enhancer.enhance(audio, exact=args.exact)
        save_wav(out, enhanced, sr)
        print(f"enhanced {inp} -> {out} ({len(audio) / sr:.2f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
