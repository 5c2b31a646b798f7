"""Calibrate the native P.862 model's mid-scale against published wb-PESQ
behavior (the port's ``benchmarks/calibrate_pesq.py``, on the port's own
copies of ``pesq_native``, the synthetic signals and the reverb augmenter;
host numpy only).

The identity ceiling and the logistic map pin only the ends of the scale;
every score of an actually degraded signal rides on the per-frame
disturbance gain ``evaluation.pesq_native._D_CAL``. This tool sweeps MOS-LQO
over controlled degradations of speech-like signals:

  * additive white Gaussian noise at SNR 0..40 dB
  * additive speech-shaped (pink) noise at the same SNRs
  * babble and mains hum, comb-filter reverb, hard clipping and MNRU-style
    multiplicative noise (Q = 10..35 dB)

and compares the white and speech-shaped curves against published wb-PESQ
(P.862.2 MOS-LQO) anchor points:

  * AWGN-on-speech wb-PESQ values widely reproduced in the enhancement
    literature (e.g. Loizou, "Speech Enhancement: Theory and Practice",
    Table 11; wb scores run ~1.2 at 0 dB to ~4.0 at 40 dB and the curve is
    near-linear in SNR between 5 and 35 dB at ~0.07 MOS/dB).
  * VoiceBank-DEMAND's noisy test input (real mixed noise, mean SNR ~9 dB,
    SI-SDR 8.5 dB) at wb-PESQ 1.97, as the reference project publishes it.

These anchors carry real uncertainty (different speech corpora shift the
curve by a few tenths of a MOS), so the fit minimizes the mean |residual|
over the table rather than chasing any single point.

    python -m speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools.calibrate_pesq \\
        [--fit] [--clips 4] [--seconds 3] [--out pesq_calibration.json]

``--fit`` grid-searches ``_D_CAL`` and reports the best value; without it the
current module constant is evaluated. ``sweep`` restores the module constant
when it returns: a fit changes no later score of the process.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..cli.synth_dataset import babble_noise, hum_noise, speechlike
from ..data.augmentation import AudioAugmenter
from ..evaluation import pesq_native

SR = 16000

# Published wb-PESQ (MOS-LQO, P.862.2) anchor targets for additive noise on
# active speech (module docstring); the 9 dB speech-shaped row stands for
# VoiceBank-DEMAND's real mixed noise.
ANCHORS_WHITE = {0: 1.25, 5: 1.45, 10: 1.75, 15: 2.05, 20: 2.45,
                 30: 3.25, 40: 4.0}
ANCHORS_PINK = {9: 1.97}
# Babble anchors are approximate: published wb-PESQ babble-noise curves
# (NOIZEUS and the enhancement literature) sit slightly above the white-noise
# curve at equal SNR; a +-0.3 MOS sanity band, not a fit target.
ANCHORS_BABBLE_APPROX = {5: 1.6, 10: 1.9, 15: 2.2}
# Families without trustworthy published anchors (mains hum, comb-filter
# reverb, hard clipping) are checked for monotonicity: the score must fall
# as the degradation strengthens.


def _mix_at_snr(clean: np.ndarray, noise: np.ndarray, snr_db: float) -> np.ndarray:
    ps = float(np.mean(clean**2))
    pn = float(np.mean(noise**2))
    g = np.sqrt(ps / (pn * 10.0 ** (snr_db / 10.0) + 1e-30))
    return clean + g * noise


def _pink(n: int, rng: np.random.Generator) -> np.ndarray:
    spec = np.fft.rfft(rng.standard_normal(n))
    f = np.maximum(np.fft.rfftfreq(n, 1.0 / SR), 1.0)
    x = np.fft.irfft(spec / np.sqrt(f), n=n)
    return (x / (np.std(x) + 1e-12)).astype(np.float64)


def _mnru(clean: np.ndarray, q_db: float, rng: np.random.Generator) -> np.ndarray:
    """Modulated-noise reference unit (ITU-T P.810): signal-correlated
    multiplicative noise at Q dB, the classic PESQ training distortion."""
    g = 10.0 ** (-q_db / 20.0)
    return clean * (1.0 + g * rng.standard_normal(len(clean)))


def sweep(
    n_clips: int,
    seconds: float,
    d_cal: float | None = None,
    fit_only: bool = False,
) -> dict:
    """Mean MOS-LQO per family and degradation, scored with ``_D_CAL`` set
    to ``d_cal`` (when given) and restored after. ``fit_only=True`` sweeps
    just the anchored families (white, pink), the fit target, so the
    ``--fit`` grid search stays cheap; the full corpus runs once for the
    report."""
    saved = pesq_native._D_CAL
    if d_cal is not None:
        pesq_native._D_CAL = d_cal
    try:
        return _sweep(n_clips, seconds, fit_only)
    finally:
        pesq_native._D_CAL = saved


def _sweep(n_clips: int, seconds: float, fit_only: bool) -> dict:
    rng = np.random.default_rng(2024)
    cleans = [speechlike(seconds, rng) for _ in range(n_clips)]
    out: dict[str, dict[float, float]] = {
        "white": {}, "pink": {}, "babble": {}, "hum": {},
        "reverb": {}, "clip": {}, "mnru": {},
    }
    babble_snrs = [] if fit_only else sorted(ANCHORS_BABBLE_APPROX)
    hum_snrs = () if fit_only else (0, 5, 15, 25)
    all_snrs = sorted(
        set(list(ANCHORS_WHITE) + list(ANCHORS_PINK) + babble_snrs)
        | set(hum_snrs)
    )
    for snr in all_snrs:
        scores: dict[str, list[float]] = {
            "white": [], "pink": [], "babble": [], "hum": []
        }
        for ci, c in enumerate(cleans):
            nz_rng = np.random.default_rng(1000 + ci)
            white = nz_rng.standard_normal(len(c))
            pink = _pink(len(c), nz_rng)
            if snr in ANCHORS_WHITE:
                scores["white"].append(
                    pesq_native.pesq_p862(c, _mix_at_snr(c, white, snr), SR, "wb")
                )
            if snr in ANCHORS_PINK:
                scores["pink"].append(
                    pesq_native.pesq_p862(c, _mix_at_snr(c, pink, snr), SR, "wb")
                )
            if snr in babble_snrs:
                bab = babble_noise(len(c), np.random.default_rng(500 + ci))
                scores["babble"].append(
                    pesq_native.pesq_p862(c, _mix_at_snr(c, bab, snr), SR, "wb")
                )
            if snr in hum_snrs:
                hum = hum_noise(len(c), np.random.default_rng(600 + ci))
                scores["hum"].append(
                    pesq_native.pesq_p862(c, _mix_at_snr(c, hum, snr), SR, "wb")
                )
        for fam, vals in scores.items():
            if vals:
                out[fam][snr] = float(np.mean(vals))
    if fit_only:
        return out
    # comb-filter reverb (the port's AudioAugmenter.add_reverb): a stronger
    # decay should score worse
    aug = AudioAugmenter(SR)
    for decay in (0.1, 0.3, 0.5, 0.7):
        s = [
            pesq_native.pesq_p862(
                c, aug.add_reverb(c.astype(np.float32), 50.0, decay), SR, "wb"
            )
            for c in cleans
        ]
        out["reverb"][decay] = float(np.mean(s))
    # hard clipping at a fraction of peak: a lower threshold should score worse
    for thresh in (0.9, 0.5, 0.3, 0.1):
        s = []
        for c in cleans:
            lim = thresh * float(np.max(np.abs(c)))
            s.append(pesq_native.pesq_p862(c, np.clip(c, -lim, lim), SR, "wb"))
        out["clip"][thresh] = float(np.mean(s))
    for q in (10, 15, 20, 25, 35):
        s = [
            pesq_native.pesq_p862(
                c, _mnru(c, q, np.random.default_rng(77 + i)), SR, "wb"
            )
            for i, c in enumerate(cleans)
        ]
        out["mnru"][q] = float(np.mean(s))
    return out


def monotonicity(out: dict) -> dict:
    """Degradation families without published anchors must at least rank
    correctly: the score falls as the degradation strengthens."""
    def non_decreasing(vals):
        return bool(all(b >= a - 0.05 for a, b in zip(vals, vals[1:])))

    checks = {}
    # rising SNR -> rising MOS
    for fam in ("white", "pink", "babble", "hum"):
        checks[fam] = non_decreasing([out[fam][x] for x in sorted(out[fam])])
    # decay ascending = strengthening reverb -> falling MOS
    checks["reverb"] = non_decreasing(
        [out["reverb"][x] for x in sorted(out["reverb"], reverse=True)]
    )
    # clip threshold ascending = weakening -> rising MOS
    checks["clip"] = non_decreasing(
        [out["clip"][x] for x in sorted(out["clip"])]
    )
    # MNRU Q ascending = weakening -> rising MOS
    checks["mnru"] = non_decreasing(
        [out["mnru"][x] for x in sorted(out["mnru"])]
    )
    return checks


def residuals(scores: dict) -> list[tuple[str, float, float, float]]:
    rows = []
    for snr, tgt in ANCHORS_WHITE.items():
        rows.append(("white", float(snr), scores["white"][snr], tgt))
    for snr, tgt in ANCHORS_PINK.items():
        rows.append(("pink", float(snr), scores["pink"][snr], tgt))
    return rows


def babble_residuals(scores: dict) -> list[tuple[str, float, float, float]]:
    """Reported separately: the babble anchors are approximate, so they
    sanity-check the fit rather than drive it."""
    return [
        ("babble", float(snr), scores["babble"][snr], tgt)
        for snr, tgt in ANCHORS_BABBLE_APPROX.items()
    ]


def per_family_stats(rows) -> dict:
    fams: dict[str, list[float]] = {}
    for fam, _, got, tgt in rows:
        fams.setdefault(fam, []).append(abs(got - tgt))
    return {
        fam: {"mean_abs_residual": float(np.mean(v)),
              "max_abs_residual": float(np.max(v)),
              "n": len(v)}
        for fam, v in fams.items()
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fit", action="store_true")
    ap.add_argument("--clips", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", type=Path, default=Path("pesq_calibration.json"),
                    help="where the JSON report goes (default ./pesq_calibration.json)")
    args = ap.parse_args(argv)

    if args.fit:
        best = None
        for d in np.arange(3.0, 14.01, 0.5):
            sc = sweep(args.clips, args.seconds, d_cal=float(d), fit_only=True)
            rows = residuals(sc)
            mae = float(np.mean([abs(got - tgt) for _, _, got, tgt in rows]))
            print(f"_D_CAL={d:5.2f}  MAE={mae:.3f}  "
                  + " ".join(f"{m}@{s:g}:{got:.2f}/{tgt:.2f}"
                             for m, s, got, tgt in rows))
            if best is None or mae < best[1]:
                best = (float(d), mae)
        print(f"\nbest _D_CAL = {best[0]} (MAE {best[1]:.3f})")
        d_cal = best[0]
    else:
        d_cal = pesq_native._D_CAL

    sc = sweep(args.clips, args.seconds, d_cal=d_cal)
    rows = residuals(sc)
    brows = babble_residuals(sc)
    mae = float(np.mean([abs(got - tgt) for _, _, got, tgt in rows]))
    mx = float(np.max([abs(got - tgt) for _, _, got, tgt in rows]))
    mono = monotonicity(sc)
    print(f"\n_D_CAL = {d_cal}")
    for m, s, got, tgt in rows + brows:
        approx = " (approx anchor)" if m == "babble" else ""
        print(f"  {m:>6s} @ {s:4.1f} dB SNR: native {got:.2f}  "
              f"published ~{tgt:.2f}  residual {got - tgt:+.2f}{approx}")
    for fam, lbl in (("hum", "SNR"), ("reverb", "decay"),
                     ("clip", "clip@"), ("mnru", "Q")):
        print(f"  {fam} sweep: "
              + "  ".join(f"{lbl}{k:g}:{v:.2f}" for k, v in sc[fam].items())
              + f"  monotonic={mono[fam]}")
    print(f"  anchored MAE {mae:.3f}, max |residual| {mx:.3f}")

    res = {
        "d_cal": d_cal,
        "clips": args.clips,
        "seconds": args.seconds,
        "scores": sc,
        "anchors": {"white": ANCHORS_WHITE, "pink": ANCHORS_PINK,
                    "babble_approx": ANCHORS_BABBLE_APPROX},
        "mae": mae,
        "max_abs_residual": mx,
        "per_family_residuals": per_family_stats(rows + brows),
        "monotonicity": mono,
    }
    args.out.write_text(json.dumps(res, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
