"""What the per-layer metric files read: the traced slice's device time and
the window's counts, against ``work``'s bounds and peaks. Each returns None
where the run has nothing to read."""

from __future__ import annotations

from . import trace, work


def slice_idle_pct(ctx):
    """Share of the traced slice in which nothing ran on the device."""
    s = ctx.summary
    if not s or s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def window_idle_pct(ctx):
    """Share of the untraced window in which nothing ran on the device: the
    slice's device seconds per FLOP times the window's FLOPs a second. The
    profiler slows the host's launches in the slice and not the kernels, so
    the slice's own idle share overstates a host-bound step's."""
    s, f = ctx.summary, ctx.facts
    if not s or s["busy_s"] <= 0 or not f.get("slice_flops") or not f.get("window_s"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / f["slice_flops"] * f["window_flops"] / f["window_s"])


def _peaks(ctx):
    return work.peaks(ctx.card) if ctx.card else None


def mfu_pct(ctx):
    """Analytic FLOPs of the window's work over its wall time, over the
    data-sheet peak of the configuration's precision."""
    f, pk = ctx.facts, _peaks(ctx)
    if pk is None or not f.get("window_s") or not f.get("window_flops"):
        return None
    return 100.0 * f["window_flops"] / f["window_s"] / pk[ctx.config["precision"]]


def tracing_cost_pct(ctx):
    """How much slower the work ran in the traced slice than in the window."""
    f = ctx.facts
    if not f.get("slice_s") or not f.get("slice_flops") or not f.get("window_s"):
        return None
    window = f["window_flops"] / f["window_s"]
    return 100.0 * (1.0 - (f["slice_flops"] / f["slice_s"]) / window)


def roofline_pct(ctx, kernels: tuple, works: list, peak: str):
    """The least time the traced calls' ``works`` (``(operations, bytes)``
    each) could take on the card, over the device time of the port's
    ``kernels`` (names of its kernel registry)."""
    s, pk = ctx.summary, _peaks(ctx)
    if not s or pk is None or not works:
        return None
    measured = trace.kernel_s(s, kernels)
    if measured <= 0:
        return None
    bound = sum(work.bound_s(o, b, pk[peak], pk["bytes_per_s"]) for o, b in works)
    return 100.0 * bound / measured


def span_mean_ms(ctx, name: str):
    f = ctx.facts
    d = ctx.spans.durations(name, f.get("t0", 0.0), f.get("t1", 0.0))
    return 1e3 * sum(d) / len(d) if d else None
