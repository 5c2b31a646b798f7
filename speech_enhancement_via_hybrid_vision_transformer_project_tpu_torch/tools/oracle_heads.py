"""Oracle reference points for output-head geometries (the port's
``benchmarks/oracle_heads.py``, with the same estimators and JSON).

Measures, per test pair and averaged, the SI-SDR improvement of five
IDEALIZED estimators, each reconstructed with the noisy phase: upper
reference points used to pick an output head before a training run.

  * ``noisy_phase``: the clean magnitude (the classic phase bound).
  * ``irm257``: clip(|S|/|X|, 0, 1) * |X| at the full 257-bin resolution,
    what an attenuation-only full-resolution mask head could at best express.
  * ``mask64``: that IRM blurred through the decoder's 64-row geometry
    (257 -> 64 -> 257 bilinear), the ``mask`` head's reference point.
  * ``mask64_t4``: ``mask64`` also blurred T -> T/4 -> T on the time axis.
  * ``mag64``: the clean magnitude through the 64-row blur, the direct
    magnitude head's reference point.

These are constructed reference points, not suprema: a trained mask can
exceed the IRM construction.

On ``cuda`` kernel K1 transforms each pair as one batch of 2 (noisy, clean),
and kernel K3 reconstructs the five estimates as one batch of 5: one launch
of each a file. ``cpu`` runs their plain versions.

    python -m speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools.oracle_heads \\
        --noisy-dir D --clean-dir D [--out results.json] [--device cuda|cpu] [--limit N]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

HEADS = ("noisy_phase", "irm257", "mask64", "mask64_t4", "mag64")


def blur(mag, rows: int, t_factor: int = 1):
    """``[F, T]`` -> bilinear down to ``(rows, T // t_factor)`` -> back."""
    from ..ops.resize import resize_bilinear

    f, t = mag.shape
    small = resize_bilinear(mag[None, None], (rows, max(1, t // t_factor)))
    return resize_bilinear(small, (f, t))[0, 0]


def measure(noisy_dir: Path, clean_dir: Path, device: str, limit: int | None = None) -> dict:
    """The JSON report over the ``*.wav`` files of ``noisy_dir`` and their
    namesakes in ``clean_dir``."""
    import torch

    from ..data.wavio import load_audio
    from ..evaluation.metrics import si_sdr
    from ..ops.cuda_stft import istft_polar, stft_mag
    from ..ops.stft import STFTConfig

    cfg = STFTConfig()
    files = sorted(Path(noisy_dir).glob("*.wav"))
    if limit:
        files = files[:limit]
    if not files:
        raise SystemExit(f"no wavs in {noisy_dir}")

    gains: dict[str, list[float]] = {h: [] for h in HEADS}
    inputs: list[float] = []
    rows = []
    with torch.inference_mode():
        for f in files:
            noisy, _ = load_audio(f)
            clean, _ = load_audio(Path(clean_dir) / f.name)
            n = min(len(noisy), len(clean))
            noisy, clean = noisy[:n], clean[:n]
            pair = torch.from_numpy(np.stack([noisy, clean])).to(device)  # a fresh [2, n]
            re, im, mag = stft_mag(pair, cfg)
            mag_x, mag_s = mag[0], mag[1]
            phase = torch.atan2(im[0], re[0])
            irm = torch.clamp(mag_s / torch.clamp(mag_x, min=1e-8), 0.0, 1.0)
            ests = torch.stack([
                mag_s,
                irm * mag_x,
                blur(irm, 64) * mag_x,
                blur(irm, 64, 4) * mag_x,
                blur(mag_s, 64),
            ])
            wavs = istft_polar(ests.contiguous(), phase.expand_as(ests).contiguous(), cfg,
                               length=n).cpu().numpy()
            base = si_sdr(clean, noisy)
            inputs.append(base)
            row = {"file": f.name, "input_si_sdr": base}
            for name, wav in zip(HEADS, wavs):
                g = si_sdr(clean, wav) - base
                gains[name].append(g)
                row[name] = round(float(g), 3)
            rows.append(row)

    result = {
        "n": len(files),
        "noisy_dir": str(noisy_dir),
        "mean_input_si_sdr": float(np.mean(inputs)),
        "note": (
            "IRM-style constructed reference points, not suprema — a "
            "trained mask can exceed them (see module docstring)"
        ),
    }
    for name in HEADS:
        g = np.asarray(gains[name])
        result[f"{name}_gain_mean"] = float(g.mean())
        result[f"{name}_gain_median"] = float(np.median(g))
    result["per_file"] = rows
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--noisy-dir", required=True, type=Path)
    ap.add_argument("--clean-dir", required=True, type=Path)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--limit", type=int, default=None)
    args = ap.parse_args(argv)

    from ..cli._runtime import use_device

    use_device(args.device)
    result = measure(args.noisy_dir, args.clean_dir, args.device, args.limit)
    print(json.dumps({k: v for k, v in result.items() if k != "per_file"}, indent=1))
    if args.out:
        args.out.write_text(json.dumps(result, indent=1))
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
