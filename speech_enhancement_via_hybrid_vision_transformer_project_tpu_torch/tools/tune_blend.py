"""Fit the ``snr_adaptive`` do-no-harm blend parameters from data (the
port's ``benchmarks/tune_blend.py``, with the same CLI, fit and JSON).

For every test pair this measures, per clip:
  * the model's self-estimated SNR (est_snr = 10*log10 |enh|^2/|mag-enh|^2,
    the signal ``AudioEnhancer``'s ``snr_adaptive`` mode thresholds on),
  * the true input SNR (needs the clean reference: offline only), and
  * the SI-SDR gain of the magnitude-domain blend a*enhanced + (1-a)*noisy
    for the 11 values of a in linspace(0, 1, 11).

It then grid-searches (pivot, width, min_blend) for the sigmoid
a(est_snr) = min + (1-min)*sigmoid((pivot-est_snr)/width) that maximizes the
mean SI-SDR improvement subject to no input-SNR bin being negative (the
do-no-harm constraint). ``--write-checkpoint-meta`` stores the winner in the
checkpoint's ``meta.json`` as ``config.inference.blend``, which
``AudioEnhancer(..., blend=None)`` adopts for a magnitude-head model.

On ``cuda`` each file launches kernel K1 once, kernel K2 once in each
transformer block, and kernel K3 once for the 11 blends as one batch;
``cpu`` runs their plain versions.

    python -m speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools.tune_blend \\
        --checkpoint CKPT --config-dir CFG --noisy-dir ... --clean-dir ... \\
        [--device cuda|cpu] [--json-out ...] [--write-checkpoint-meta]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

ALPHAS = np.linspace(0.0, 1.0, 11)
EDGES = [-5.0, 0.0, 5.0, 10.0, 15.0]  # input SI-SDR bins of the do-no-harm constraint


def measure_file(model, noisy: np.ndarray, clean: np.ndarray, cfg, output_mode: str,
                 device: str) -> dict:
    """One pair's ``input_si_sdr``, ``est_snr`` and the 11 blends' SI-SDR
    ``gains``."""
    import torch

    from ..evaluation.metrics import si_sdr
    from ..ops.cuda_stft import istft_polar, stft_mag

    n = len(noisy)
    with torch.inference_mode():
        x = torch.from_numpy(noisy[None]).to(device)
        mx = torch.amax(torch.abs(x))
        scale = torch.where(mx > 1e-8, mx, torch.ones_like(mx))
        re, im, mag = stft_mag(x / scale, cfg)
        ph = torch.atan2(im, re)
        mm = torch.amax(mag)
        mm = torch.where(mm > 1e-8, mm, torch.ones_like(mm))
        out = model((mag / mm)[..., None])[..., 0]
        if output_mode == "mask":
            enh = torch.clamp((out + 1.0) * 0.5, 0.0, 1.0) * mag
        else:
            enh = out * mm
        sig = float(torch.sum(enh**2))
        res = float(torch.sum((mag - enh) ** 2))
        est_snr = 10.0 * np.log10(max(sig, 1e-12) / max(res, 1e-12))
        # each blend's two weights rounded to float32 from float64, as the
        # JAX tool's scalar a and 1 - a are
        a = torch.from_numpy(ALPHAS.astype(np.float32)).to(device).view(-1, 1, 1)
        b = torch.from_numpy((1 - ALPHAS).astype(np.float32)).to(device).view(-1, 1, 1)
        bl = a * enh + b * mag
        y = istft_polar(bl, ph.expand_as(bl).contiguous(), cfg, length=n)
        y = y.cpu().numpy() * float(scale)
    base = si_sdr(clean, noisy)
    gains = [si_sdr(clean, yi) - base for yi in y]
    return {
        "input_si_sdr": float(base),
        "est_snr": float(est_snr),
        "gains": [float(g) for g in gains],
    }


def _bin_of(s: float) -> int:
    return int(np.searchsorted(EDGES, s, side="right"))


def evaluate_blend(rows: list[dict], pivot: float, width: float, mn: float):
    """``(mean gain, {bin: mean gain})`` over ``rows`` of the sigmoid blend
    with these parameters; bins are keyed by the input SI-SDR bin's index."""
    per_bin: dict[int, list[float]] = {}
    total = []
    for r in rows:
        a = mn + (1 - mn) / (1 + np.exp(-(pivot - r["est_snr"]) / width))
        g = float(np.interp(a, ALPHAS, r["gains"]))
        total.append(g)
        per_bin.setdefault(_bin_of(r["input_si_sdr"]), []).append(g)
    bins = {b: float(np.mean(v)) for b, v in per_bin.items()}
    return float(np.mean(total)), bins


def grid(rows: list[dict]):
    """Every point of the search in its order: ``(mean, bins, params,
    feasible)``, feasible when no bin's mean gain is below -0.1 dB."""
    for pivot in np.arange(4.0, 26.1, 2.0):
        for width in (1.0, 2.0, 4.0, 8.0):
            for mn in (0.0, 0.1, 0.2, 0.3):
                mean, bins = evaluate_blend(rows, pivot, width, mn)
                params = dict(pivot=float(pivot), width=float(width), min=float(mn))
                yield mean, bins, params, all(v >= -0.1 for v in bins.values())


def fit_blend(rows: list[dict]) -> dict:
    """The grid search under the no-negative-bin constraint: ``{"no_blend":
    {"mean", "bins"}, "best": None or {"params": {pivot, width, min},
    "mean", "bins"}}``. The first feasible point of the largest mean wins."""
    best = None
    for mean, bins, params, ok in grid(rows):
        if ok and (best is None or mean > best["mean"]):
            best = {"params": params, "mean": mean, "bins": bins}
    raw_mean, raw_bins = evaluate_blend(rows, -100.0, 1.0, 1.0)  # alpha == 1 everywhere
    return {"no_blend": {"mean": raw_mean, "bins": raw_bins}, "best": best}


def write_checkpoint_blend(checkpoint: str | Path, best: dict, fitted_on: str) -> Path:
    """Store a fit's parameters as ``config.inference.blend`` in the
    checkpoint's ``meta.json``."""
    meta_path = Path(checkpoint) / "meta.json"
    meta = json.loads(meta_path.read_text())
    meta.setdefault("config", {}).setdefault("inference", {})["blend"] = {
        "mode": "snr_adaptive",
        "min": best["params"]["min"],
        "pivot_db": best["params"]["pivot"],
        "width_db": best["params"]["width"],
        "fitted_mean_gain_db": best["mean"],
        "fitted_on": str(fitted_on),
    }
    meta_path.write_text(json.dumps(meta, indent=1, default=float))
    return meta_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--config-dir", default="config")
    ap.add_argument("--noisy-dir", required=True)
    ap.add_argument("--clean-dir", required=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--max-files", type=int, default=None)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--write-checkpoint-meta", action="store_true",
                    help="store the winning snr_adaptive parameters in the "
                         "checkpoint's meta.json (config.inference.blend) "
                         "so AudioEnhancer adopts them by default (a "
                         "magnitude checkpoint served raw at blend=1.0 "
                         "measurably harms clean input)")
    args = ap.parse_args(argv)

    from ..cli._runtime import caller_config, use_device

    use_device(args.device)

    from ..data.wavio import load_audio
    from ..inference import load_model_for_inference
    from ..ops.stft import STFTConfig

    model, config = load_model_for_inference(args.checkpoint, caller_config(args.config_dir),
                                             device=args.device)
    audio_cfg = config.get("audio", {})
    cfg = STFTConfig(
        n_fft=audio_cfg.get("n_fft", 512),
        hop_length=audio_cfg.get("hop_length", 128),
        win_length=audio_cfg.get("win_length", 512),
    )
    output_mode = config.get("model", {}).get("output_mode", "magnitude")
    sr = audio_cfg.get("sample_rate", 16000)

    nd, cd = Path(args.noisy_dir), Path(args.clean_dir)
    files = sorted(f for f in nd.glob("*.wav") if (cd / f.name).exists())
    if args.max_files:
        files = files[: args.max_files]

    rows = []
    for f in files:
        noisy, _ = load_audio(f, sr)
        clean, _ = load_audio(cd / f.name, sr)
        row = {"file": f.name, **measure_file(model, noisy, clean, cfg, output_mode, args.device)}
        rows.append(row)
        gains = row["gains"]
        print(f"{f.name}: in={row['input_si_sdr']:5.1f} est={row['est_snr']:5.1f} "
              f"g(a=1)={gains[-1]:+5.2f} g(a=0)={gains[0]:+5.2f}", flush=True)

    fit = fit_blend(rows)
    best = fit["best"]
    print(f"\nno blend (a=1): mean {fit['no_blend']['mean']:+.2f}  "
          f"bins {fit['no_blend']['bins']}")
    if best:
        print(f"best no-harm fit: {best['params']}  mean {best['mean']:+.2f}  "
              f"bins {best['bins']}")
    else:
        print("no parameter setting satisfies the no-harm constraint")

    if args.write_checkpoint_meta:
        if best is None:
            print("no no-harm fit found — checkpoint meta NOT updated")
        else:
            meta_path = write_checkpoint_blend(args.checkpoint, best, args.noisy_dir)
            print(f"fitted blend parameters written to {meta_path}")

    if args.json_out:
        Path(args.json_out).write_text(json.dumps({
            "checkpoint": str(args.checkpoint),
            "output_mode": output_mode,
            "alphas": [float(a) for a in ALPHAS],
            "rows": rows,
            **fit,
        }, indent=1))
        print(f"wrote {args.json_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
