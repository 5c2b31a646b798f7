"""Host-side audio I/O: the port's native C++ decoder against its numpy
codec (the port's ``benchmarks/bench_io.py``, with its flags).

The input pipeline's host work is WAV decode and mixdown. This measures the
port's C++ runtime (``native/``: ``read_wav`` a file through
``data.wavio.load_audio``, and ``decode_batch``'s thread pool) against the
numpy codec (``data/wavio.py``) on a synthetic corpus of PCM16 files written
by the port's ``save_wav`` (or on the WAV files of ``--dir``), best of
``--repeats``. ``--device cuda`` (the
default) also times the decoded batch's copy to the card, as a loader batch
goes (``training.trainer.batch_to_device``), and needs a card; ``--device
cpu`` decodes only. The decode times are the host's on either device.

    python -m speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools.bench_io \\
        [--files 64] [--seconds 3.0] [--threads 4] [--repeats 3] [--dir DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--files", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--dir", default=None,
                    help="decode the *.wav files of this directory instead of a synthetic corpus")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: also the decoded batch's copy to the card")
    args = ap.parse_args(argv)

    import torch

    from .. import native
    from ..cli._runtime import use_device
    from ..data.wavio import load_audio, save_wav
    from .flops import card_line, describe_device

    use_device(args.device)
    sr = 16000
    rng = np.random.default_rng(0)

    def bench(fn):
        best = float("inf")
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    with tempfile.TemporaryDirectory(prefix="sevit_io_") as tmp:
        if args.dir:
            paths = sorted(Path(args.dir).glob("*.wav"))
            what = f"{len(paths)} files of {args.dir}"
        else:
            paths = [Path(tmp) / f"f{i:04d}.wav" for i in range(args.files)]
            for p in paths:
                save_wav(p, (0.3 * rng.standard_normal(int(sr * args.seconds))).astype(np.float32),
                         sr)
            what = f"{args.files} files x {args.seconds:.1f}s"
        lens = [len(load_audio(p, sr, use_native=False)[0]) for p in paths]
        audio_s = sum(lens) / sr
        print(f"corpus: {what}, {audio_s:.1f} audio-s (native available: {native.available()}); "
              f"{card_line(describe_device(args.device))}")

        t_np = bench(lambda: [load_audio(p, sr, use_native=False) for p in paths])
        print(f"numpy parser        : {t_np * 1e3:8.1f} ms  ({audio_s / t_np:,.0f} audio-s/s)")
        if native.available():
            t_nat = bench(lambda: [load_audio(p, sr, use_native=True) for p in paths])
            print(f"native (per-file)   : {t_nat * 1e3:8.1f} ms  ({audio_s / t_nat:,.0f} audio-s/s)")
            t_batch = bench(lambda: native.decode_batch([str(p) for p in paths], max(lens),
                                                        num_threads=args.threads))
            print(f"native (batch, {args.threads}t) : {t_batch * 1e3:8.1f} ms  "
                  f"({audio_s / t_batch:,.0f} audio-s/s)  {t_np / t_batch:.1f}x vs numpy")
        if args.device == "cuda":
            batch = np.zeros((len(paths), max(lens)), np.float32)
            for row, p in enumerate(paths):
                x = load_audio(p, sr)[0]
                batch[row, : len(x)] = x

            def copy():
                torch.from_numpy(batch).to(args.device)
                torch.cuda.synchronize()

            copy()
            t_copy = bench(copy)
            print(f"batch to the card   : {t_copy * 1e3:8.1f} ms  "
                  f"({batch.nbytes / 1e6 / t_copy:,.0f} MB/s, {batch.nbytes / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
