"""Shared --blend* CLI plumbing for enhance/evaluate/serve (a copy of the
JAX package's ``cli/_blendargs.py``).

One definition of the do-no-harm flags and their defaults: a re-tuning of
the fitted blend parameters (benchmarks/tune_blend.py) edits this file
only, so the three serving CLIs can never drift apart.
"""

from __future__ import annotations

import argparse


def add_blend_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--blend", default=None,
                   help="do-no-harm output mix: float in [0,1] (fraction "
                        "of enhanced magnitude; 1.0 = pure model output) "
                        "or 'snr_adaptive' (per-clip back-off on "
                        "already-clean input). Default: adopt the "
                        "checkpoint's fitted parameters when present "
                        "(tune_blend.py --write-checkpoint-meta), else "
                        "1.0 — with a warning for magnitude-head models, "
                        "where raw output measurably harms clean input")
    p.add_argument("--blend-min", type=float, default=0.3,
                   help="snr_adaptive floor: minimum enhanced fraction")
    p.add_argument("--blend-pivot-db", type=float, default=18.0,
                   help="snr_adaptive pivot: est-SNR (dB) of half back-off "
                        "(fit per model with benchmarks/tune_blend.py)")
    p.add_argument("--blend-width-db", type=float, default=4.0,
                   help="snr_adaptive transition width (dB)")


def parse_blend(value):
    if value is None:
        return None  # AUTO: enhancer adopts checkpoint-fitted params
    try:
        return float(value)
    except ValueError:
        return value


def blend_kwargs(args: argparse.Namespace) -> dict:
    """AudioEnhancer keyword arguments from parsed --blend* flags."""
    return dict(
        blend=parse_blend(args.blend),
        blend_min=args.blend_min,
        blend_pivot_db=args.blend_pivot_db,
        blend_width_db=args.blend_width_db,
    )
