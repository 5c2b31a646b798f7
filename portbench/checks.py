"""The comparisons that decide ``correct``, against the plain reference.

Enhancement (serving and offline): each checked clip's output against the
reference's, as the widest gap in PCM16 steps (``pcm16_lsb_max``: 1/32767 of
full scale); the worst clip's RMS gap, in steps and over its RMS, is read
beside it (a quiet clip's PCM16 rounding alone makes the relative one large). Training: the gap of the first step's loss over the
reference's (``loss_step1_rel``; the later steps' is read, not compared: see
PERF.md); per parameter the gap
between the norms of the first step's clipped gradient, as the optimizer
got it, and of the change over three steps, each over the larger of the
reference's norm of that parameter and of the median parameter
(``grad_norm_gap_max``, ``change_norm_gap_max``). A parameter whose
reference gradient is under a thousandth of the median parameter's moves
by round-off alone under Adam and is left out of the change.
"""

from __future__ import annotations

import numpy as np
import torch

from . import weights
from .reference import hvit, pipeline

ROWS = 32  # the reference's rows a block


def enhancement_gaps(outs: list, refs: list) -> dict:
    """The widest gap in PCM16 steps over every checked clip (compared), and
    each clip's RMS gap in steps and over its RMS, the worst clip's (read)."""
    lsb, rms, rel = 0.0, 0.0, 0.0
    for o, r in zip(outs, refs):
        if o is None or len(o) != len(r):
            return {"pcm16_lsb_max": float("inf")}
        d = (o.astype(np.float64) - r.astype(np.float64)) * 32767.0
        lsb = max(lsb, float(np.abs(d).max()))
        rms = max(rms, float(np.sqrt(np.mean(d * d))))
        ref_rms = float(np.sqrt(np.mean((r.astype(np.float64) * 32767.0) ** 2)))
        rel = max(rel, float(np.sqrt(np.mean(d * d))) / max(ref_rms, 1e-12))
    return {"pcm16_lsb_max": lsb, "rms_lsb_max": rms, "rel_rms_max": rel}


def reference_enhance(config: dict, seed: int, batches: list, device, shapes: dict,
                      tf32: bool = False) -> list:
    """The reference's outputs of ``batches``: each a list of PCM16 clips
    padded together to ``padded_len`` (``(padded_len, clips)``), run in
    blocks of ``ROWS``; weights drawn again from the seed."""
    p = weights.draw(shapes, seed, device)
    outs = []
    with hvit.lower_precision(tf32):
        for padded_len, clips in batches:
            for i in range(0, len(clips), ROWS):
                outs.extend(pipeline.enhance_rows(p, config, clips[i:i + ROWS], padded_len,
                                                  device))
    del p
    return outs


def enhancement_check(config: dict, seed: int, device, shapes: dict, batches: list,
                      outs: list, control: bool):
    """``(numbers, control numbers or None)`` of the program's ``outs`` of
    ``batches``."""
    refs = reference_enhance(config, seed, batches, device, shapes)
    numbers = enhancement_gaps(outs, refs)
    ctrl = None
    if control:
        low = reference_enhance(config, seed, batches, device, shapes, tf32=True)
        ctrl = enhancement_gaps(low, refs)
    return numbers, ctrl


def train_gaps(prog: dict, ref: dict) -> dict:
    losses = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(prog["losses"], ref["losses"])]
    if len(losses) != len(ref["losses"]):
        losses = [float("inf")]
    g_ref = ref["grad_norms"]
    median_g = float(np.median(list(g_ref.values())))
    c_ref = ref["change_norms"]
    median_c = float(np.median(list(c_ref.values())))
    grad = {n: abs(prog["grad_norms"][n] - g) / max(g, median_g) for n, g in g_ref.items()}
    moved = [n for n, g in g_ref.items() if g >= 1e-3 * median_g]
    change = {n: abs(prog["change_norms"][n] - c_ref[n]) / max(c_ref[n], median_c)
              for n in moved}
    worst_g, worst_c = max(grad, key=grad.get), max(change, key=change.get)
    return {"loss_step1_rel": losses[0], "loss_later_rel_max": max(losses[1:], default=0.0),
            "grad_norm_gap_max": grad[worst_g], "change_norm_gap_max": change[worst_c],
            "grad_gap_leaf": worst_g, "change_gap_leaf": worst_c,
            "left_out_of_change": sorted(set(g_ref) - set(moved))}


def reference_train(config: dict, seed: int, device, shapes: dict, batches: list,
                    recipe: dict, tf32: bool = False) -> dict:
    p = weights.draw(shapes, seed, device)
    feed = [{k: torch.from_numpy(np.asarray(v)).to(device) for k, v in b.items()}
            for b in batches]
    with hvit.lower_precision(tf32):
        out = pipeline.train_steps(p, config, feed, recipe)
    del p, feed
    return out


def train_check(config: dict, seed: int, device, shapes: dict, batches: list, recipe: dict,
                prog: dict, control: bool):
    ref = reference_train(config, seed, device, shapes, batches, recipe)
    numbers = train_gaps(prog, ref)
    ctrl = None
    if control:
        low = reference_train(config, seed, device, shapes, batches, recipe, tf32=True)
        ctrl = train_gaps(low, ref)
    return numbers, ctrl
