"""Evaluation CLI (JAX ``cli/evaluate.py``, same flags): enhance a paired
test set on a CUDA card (or the CPU), score every file and write the
results as JSON.

    python -m speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli.evaluate \\
        --checkpoint ckpt/best_model --noisy-dir noisy --clean-dir clean --output results.json

PESQ is the ITU implementation where the ``pesq`` package is installed,
else the native P.862 model (``evaluation/pesq_native.py``); the JSON's
``summary._meta.pesq_impl`` says which. Never compare scores of the two.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ._blendargs import add_blend_args, blend_kwargs
from ._runtime import caller_config, data_parallel_mesh, use_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate a trained enhancer on VoiceBank-DEMAND "
                                            "(PyTorch)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--config-dir", default="config")
    p.add_argument("--data-root", default=None)
    p.add_argument("--noisy-dir", default=None)
    p.add_argument("--clean-dir", default=None)
    p.add_argument("--output", default="evaluation_results.json")
    p.add_argument("--save-enhanced", default=None, help="directory to dump enhanced wavs")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-files", type=int, default=None)
    p.add_argument("--no-pesq", action="store_true")
    p.add_argument("--metric-workers", type=int, default=None,
                   help="process-pool size for per-file metric scoring (default "
                        "max(1, min(8, cpu_count - 2)); 0 or 1 = serial). Results "
                        "are identical to serial; only wall time changes")
    p.add_argument("--exact", action="store_true",
                   help="reference-exact per-file enhancement (no bucket padding; slower)")
    p.add_argument("--data-parallel", type=int, default=1,
                   help="replicas to split each batch's rows over: cuda:0..N-1, "
                        "or N on the CPU")
    add_blend_args(p)
    p.add_argument("--mask-padding", action="store_true",
                   help="exclude bucket-padding patches from attention via "
                        "the model's key-padding mask (bucketed mode only)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    use_device(args.device)
    mesh = data_parallel_mesh(args.data_parallel, args.device)

    from ..evaluation.evaluator import Evaluator
    from ..inference import AudioEnhancer, load_model_for_inference

    model, config = load_model_for_inference(args.checkpoint, caller_config(args.config_dir),
                                             device=args.device)
    enhancer = AudioEnhancer(model, config, device=args.device,
                             mask_padding=args.mask_padding, mesh=mesh, **blend_kwargs(args))
    dcfg = config.get("data", {})
    data_root = Path(args.data_root or dcfg.get("data_root", "data/voicebank_demand"))
    noisy_dir = Path(args.noisy_dir or data_root / dcfg.get("noisy_test_dir", "noisy_testset_wav"))
    clean_dir = Path(args.clean_dir or data_root / dcfg.get("clean_test_dir", "clean_testset_wav"))

    sr = config.get("audio", {}).get("sample_rate", 16000)
    with Evaluator(enhancer, sr, include_pesq=not args.no_pesq) as evaluator:
        results = evaluator.evaluate_dataset(
            noisy_dir, clean_dir, output_dir=args.save_enhanced, batch_size=args.batch_size,
            max_files=args.max_files, exact=args.exact, metric_workers=args.metric_workers,
        )
    print(Evaluator.format_report(results))
    # per-file rows stay in the JSON: the per-SNR bins and do-no-harm
    # claims are auditable only from them
    Evaluator.save_results(results, args.output)
    print(f"results written to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
