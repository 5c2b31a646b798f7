"""Generate a synthetic SNR-mixed dataset in the VoiceBank-DEMAND layout
(the port's counterpart of the repository's ``scripts/synth_dataset.py``:
the same arguments, and the same files, byte for byte, from the same
``--seed``).

Speech-like synthetic cleans (harmonic carriers with pitch wobble,
syllabic amplitude modulation and formant-like band emphasis) are mixed with
coloured noise at a uniform-random SNR through the port's
``ops.audio.mix_at_snr`` and written with its ``data.save_wav``; numpy and
scipy only.

Usage: python -m speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli.synth_dataset
       OUT_DIR [--train N] [--test N] [--seed S] [--snr-low DB] [--snr-high DB]
"""

import argparse
from pathlib import Path

import numpy as np

from ..data.wavio import save_wav
from ..ops.audio import mix_at_snr

SR = 16000


def speechlike(seconds: float, rng: np.random.Generator) -> np.ndarray:
    """Formant-synthesized speech-like signal: mixed pulse-train/noise
    excitation through a cascade of 2nd-order formant resonators, with
    pitch wobble, syllabic AM and spectral tilt.

    Broadband formant structure (bandwidths of hundreds of Hz spanning
    many STFT bins) is essential here: the HybridViT decoder's final
    bilinear resize upsamples frequency 64->257 bins
    (``models/hybrid_vit.py``), so spectra made of isolated harmonic lines
    are unrecoverable through the architecture."""
    from scipy.signal import lfilter

    n = int(SR * seconds)
    t = np.arange(n) / SR
    f0 = rng.uniform(90, 220) * (
        1 + 0.06 * np.sin(2 * np.pi * rng.uniform(1.0, 3.0) * t)
    )
    phase = 2 * np.pi * np.cumsum(f0) / SR
    pulses = (np.diff(np.floor(phase / (2 * np.pi)), prepend=0) > 0).astype(
        np.float64
    )
    noise_frac = 0.6  # noise-dominant excitation keeps spectra smooth
    vmix = (1 - noise_frac) * 0.5 * (
        1 + np.sin(2 * np.pi * rng.uniform(0.8, 2.0) * t + rng.uniform(0, 6))
    )
    exc = pulses * vmix + noise_frac * 0.3 * rng.standard_normal(n)
    y = exc
    for fc, bw in (
        (rng.uniform(300, 800), 240.0),
        (rng.uniform(900, 2200), 360.0),
        (rng.uniform(2300, 3400), 520.0),
    ):
        r = np.exp(-np.pi * bw / SR)
        th = 2 * np.pi * fc / SR
        y = lfilter([1 - r], [1, -2 * r * np.cos(th), r * r], y)
    y = lfilter([1], [1, -0.9], y)  # -6 dB/oct spectral tilt
    env = 0.5 * (
        1 + np.sin(2 * np.pi * rng.uniform(2.0, 5.0) * t + rng.uniform(0, 6))
    )
    env = env ** rng.uniform(1.0, 2.0)
    y *= env
    y = y / (np.abs(y).max() + 1e-9) * rng.uniform(0.4, 0.8)
    return y.astype(np.float32)


def hum_noise(
    n: int, rng: np.random.Generator, white: np.ndarray | None = None
) -> np.ndarray:
    """Mains-hum harmonics + white floor (DEMAND-ish office noise).
    Draw order is part of the RNG-stream contract with ``coloured_noise``."""
    if white is None:
        white = rng.standard_normal(n)
    base = rng.choice([50.0, 60.0])
    t = np.arange(n) / SR
    hum = sum(
        rng.uniform(0.3, 1.0) * np.sin(2 * np.pi * base * h * t
                                       + rng.uniform(0, 6))
        for h in range(1, 7)
    )
    x = hum / (np.abs(hum).max() + 1e-9) + 0.15 * white
    return (x / (np.abs(x).max() + 1e-9)).astype(np.float32)


def babble_noise(
    n: int, rng: np.random.Generator, white: np.ndarray | None = None
) -> np.ndarray:
    """Babble-like: syllabically AM-modulated pink noise. Draw order is
    part of the RNG-stream contract with ``coloured_noise``."""
    if white is None:
        white = rng.standard_normal(n)
    spec = np.fft.rfft(white)
    freqs = np.maximum(np.fft.rfftfreq(n, 1.0 / SR), 1.0)
    t = np.arange(n) / SR
    am = 1.0 + 0.6 * np.sin(2 * np.pi * rng.uniform(2.0, 6.0) * t
                            + rng.uniform(0, 6))
    x = np.fft.irfft(spec / np.sqrt(freqs), n=n) * am
    return (x / (np.abs(x).max() + 1e-9)).astype(np.float32)


def impulsive_noise(
    n: int, rng: np.random.Generator, white: np.ndarray | None = None
) -> np.ndarray:
    """Impulsive/crackle noise: a Poisson-ish train of decaying clicks +
    intermittently gated band-limited bursts (keyboard/crockery/crackle).
    Non-stationary in a way none of the five training families are: the
    held-out test family (only reachable with ``n_families=6``; training
    sets keep the default 5, so models never see it). Draw order is part of
    the RNG-stream contract with ``coloured_noise``."""
    if white is None:
        white = rng.standard_normal(n)
    x = np.zeros(n, np.float64)
    rate = rng.uniform(4.0, 14.0)  # clicks per second
    n_clicks = max(1, int(rate * n / SR))
    pos = rng.integers(0, n, size=n_clicks)
    amp = rng.uniform(0.3, 1.0, size=n_clicks) * rng.choice(
        [-1.0, 1.0], size=n_clicks
    )
    decay = np.exp(-np.arange(int(0.008 * SR)) / (0.002 * SR))
    for p, a in zip(pos, amp):
        end = min(n, p + len(decay))
        x[p:end] += a * decay[: end - p]
    # intermittent band-limited bursts gated at a syllabic-ish rate
    spec = np.fft.rfft(white)
    freqs = np.fft.rfftfreq(n, 1.0 / SR)
    lo = rng.uniform(800, 3000)
    hi = lo + rng.uniform(1000, 4000)
    band = np.fft.irfft(spec * ((freqs >= lo) & (freqs <= hi)), n=n)
    t = np.arange(n) / SR
    gate = (
        np.sin(2 * np.pi * rng.uniform(0.5, 1.5) * t + rng.uniform(0, 6))
        > rng.uniform(-0.2, 0.5)
    ).astype(np.float64)
    x += 0.6 * band / (np.abs(band).max() + 1e-9) * gate
    return (x / (np.abs(x).max() + 1e-9)).astype(np.float32)


FAMILY_NAMES = ("white", "pink", "bandpass", "hum", "babble", "impulsive")


def coloured_noise(
    n: int,
    rng: np.random.Generator,
    n_families: int = 5,
    return_kind: bool = False,
):
    """White/pink/band-limited/hum/babble(/impulsive) noise mix — varied
    enough that the model can't just learn one fixed spectral subtraction.

    ``n_families`` pins how many noise kinds are drawn from (in the order
    white, pink, band-pass, mains-hum, babble, impulsive). Tests that
    regression-pin a training budget against a fixed data distribution pass
    ``n_families=3``, so extending this function with new families does not
    shift their RNG stream. Family 5 (impulsive) is the held-out evaluation
    family: train sets are generated with the default 5, so it stays
    unseen. The draws are the repository script's, one for one: a change
    here must be made there too.

    ``return_kind=True`` additionally returns the drawn family name
    (identical RNG stream either way).
    """
    white = rng.standard_normal(n)
    spec = np.fft.rfft(white)
    freqs = np.maximum(np.fft.rfftfreq(n, 1.0 / SR), 1.0)
    kind = int(rng.integers(0, n_families))
    if kind == 0:  # white
        shaped = spec
    elif kind == 1:  # pink
        shaped = spec / np.sqrt(freqs)
    elif kind == 2:  # band-passed rumble/hiss
        lo, hi = sorted(rng.uniform(100, 7000, size=2))
        shaped = spec * ((freqs >= lo) & (freqs <= hi))
    elif kind == 3:  # mains-hum harmonics + white floor (DEMAND-ish office)
        out = hum_noise(n, rng, white)
        return (out, FAMILY_NAMES[kind]) if return_kind else out
    elif kind == 4:  # babble-like: syllabically AM-modulated pink noise
        out = babble_noise(n, rng, white)
        return (out, FAMILY_NAMES[kind]) if return_kind else out
    else:  # impulsive clicks + gated bursts (the held-out family)
        out = impulsive_noise(n, rng, white)
        return (out, FAMILY_NAMES[kind]) if return_kind else out
    x = np.fft.irfft(shaped, n=n)
    out = (x / (np.abs(x).max() + 1e-9)).astype(np.float32)
    return (out, FAMILY_NAMES[kind]) if return_kind else out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", type=Path)
    ap.add_argument("--train", type=int, default=64)
    ap.add_argument("--test", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--snr-low", type=float, default=0.0)
    ap.add_argument("--snr-high", type=float, default=10.0)
    ap.add_argument("--min-seconds", type=float, default=1.0)
    ap.add_argument("--max-seconds", type=float, default=3.0)
    ap.add_argument(
        "--families", type=int, default=5,
        help="noise families drawn from (default 5 keeps the training "
             "distribution; family 6 = impulsive is reserved "
             "for held-out evaluation via --test-unseen)",
    )
    ap.add_argument(
        "--test-unseen", type=int, default=0,
        help="additional test pairs (u*.wav) mixed with the held-out "
             "impulsive family only, drawn from an independent RNG "
             "stream — models trained on default sets never saw it",
    )
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    manifest = {}
    splits = (
        ("clean_trainset_28spk_wav", "noisy_trainset_28spk_wav", args.train, "p"),
        ("clean_testset_wav", "noisy_testset_wav", args.test, "t"),
    )
    for clean_dir, noisy_dir, count, prefix in splits:
        for i in range(count):
            sec = rng.uniform(args.min_seconds, args.max_seconds)
            clean = speechlike(sec, rng)
            noise, family = coloured_noise(
                len(clean), rng, n_families=args.families, return_kind=True
            )
            snr = rng.uniform(args.snr_low, args.snr_high)
            noisy = mix_at_snr(clean, noise, snr)
            name = f"{prefix}{i:03d}.wav"
            save_wav(args.out / clean_dir / name, clean, SR)
            save_wav(args.out / noisy_dir / name, noisy.astype(np.float32), SR)
            manifest[name] = {
                "split": "train" if prefix == "p" else "test",
                "family": family,
                "snr_db": round(float(snr), 3),
                "seconds": round(float(sec), 3),
            }
    # Held-out-family test pairs ride an INDEPENDENT stream so adding or
    # resizing them can never perturb the seen-split draws above.
    urng = np.random.default_rng(args.seed + 990_001)
    for i in range(args.test_unseen):
        sec = urng.uniform(args.min_seconds, args.max_seconds)
        clean = speechlike(sec, urng)
        noise = impulsive_noise(len(clean), urng)
        snr = urng.uniform(args.snr_low, args.snr_high)
        noisy = mix_at_snr(clean, noise, snr)
        name = f"u{i:03d}.wav"
        save_wav(args.out / "clean_testset_wav" / name, clean, SR)
        save_wav(
            args.out / "noisy_testset_wav" / name, noisy.astype(np.float32), SR
        )
        manifest[name] = {
            "split": "test",
            "family": "impulsive",
            "unseen": True,
            "snr_db": round(float(snr), 3),
            "seconds": round(float(sec), 3),
        }
    import json

    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "manifest.json").write_text(json.dumps(manifest, indent=1))
    print(
        f"wrote {args.train} train + {args.test} test "
        f"+ {args.test_unseen} unseen-family test pairs to {args.out} "
        f"(SNR {args.snr_low}..{args.snr_high} dB; manifest.json has "
        f"per-file family/snr)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
