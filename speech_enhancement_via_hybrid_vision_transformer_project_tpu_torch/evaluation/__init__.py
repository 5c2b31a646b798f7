"""Evaluation layer: objective metrics and the dataset evaluator.

``Evaluator`` is imported on first use: a spawned metric worker imports
``evaluation.metrics``, and with it this package, and must load only numpy
and scipy, not torch and the enhancer.
"""

from .metrics import (  # noqa: F401
    compute_all_metrics,
    log_spectral_distance,
    pesq_score,
    print_metrics,
    segmental_snr,
    si_sdr,
    snr,
    stoi,
)
from .pesq_native import pesq_p862  # noqa: F401


def __getattr__(name: str):
    if name == "Evaluator":
        from .evaluator import Evaluator

        return Evaluator
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
