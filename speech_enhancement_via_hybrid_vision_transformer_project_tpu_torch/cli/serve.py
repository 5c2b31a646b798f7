"""Serving CLI: batched enhancement over HTTP on a CUDA card (or the CPU).

    python -m speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli.serve \\
        --checkpoint ckpt/best_model --device cuda --port 8080
    curl -s --data-binary @noisy.wav http://127.0.0.1:8080/enhance > out.wav

The model's architecture, audio and output mode come from the checkpoint's
``meta.json``; ``--config-dir`` supplies the runtime sections (a fitted
``inference.blend``) where ``meta.json`` has none. On ``--device cuda``
the STFT, attention and iSTFT kernels are built from ``csrc/`` with nvcc
at the first request, or at start-up with ``--warmup``.
"""

from __future__ import annotations

import argparse

from ._blendargs import add_blend_args, blend_kwargs
from ._runtime import caller_config, data_parallel_mesh, use_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Batched enhancement server (PyTorch)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--config-dir", default="config")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-batch", type=int, default=32,
                   help="dynamic-batcher coalescing limit (the batch the "
                        "port's throughput is measured at)")
    p.add_argument("--max-wait-ms", type=float, default=10.0,
                   help="max time a request waits for batch peers")
    p.add_argument("--io-dtype", default="int16", choices=["float32", "int16"],
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
    p.add_argument("--warmup", action="store_true",
                   help="build the kernels and run each common bucket once "
                        "at start-up")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    use_device(args.device)
    mesh = data_parallel_mesh(args.data_parallel, args.device)

    import numpy as np

    from ..inference import AudioEnhancer, load_model_for_inference, make_server

    model, config = load_model_for_inference(args.checkpoint, caller_config(args.config_dir),
                                             device=args.device)
    enhancer = AudioEnhancer(
        model, config, device=args.device, io_dtype=args.io_dtype, fold_bn=args.fold_bn,
        dft_precision=args.dft_precision, mesh=mesh, **blend_kwargs(args),
    )
    if args.warmup:
        for seconds in (1.0, 2.0, 4.0):
            print(f"warmup: {seconds:.0f}s bucket ...", flush=True)
            enhancer.enhance_batch([np.zeros(int(enhancer.sample_rate * seconds), np.float32)])

    server = make_server(
        enhancer, args.host, args.port,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
    )
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port}  (POST /enhance, GET /healthz, GET /stats)",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.batcher.close()
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
