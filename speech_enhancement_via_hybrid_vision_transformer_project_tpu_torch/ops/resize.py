"""Spatial resizes of the decoder and heads (JAX ``ops/resize.py``).

The JAX package builds torch's ``F.interpolate`` semantics out of static
matrices; here they are PyTorch's own operators.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of ``x [B, C, H, W]`` with half-pixel centers and no
    antialiasing, also on downscale (``align_corners=False``)."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(
        x, size=tuple(out_hw), mode="bilinear", align_corners=False,
        antialias=False,
    )


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer nearest upsample of ``x [B, C, H, W]``: an exact repeat."""
    if factor == 1:
        return x
    return F.interpolate(x, scale_factor=factor, mode="nearest")


@functools.lru_cache(maxsize=None)
def _linear_taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(lo, hi, frac)`` per output position of the half-pixel linear map
    (``align_corners=False``, no antialiasing)."""
    if in_size == 1:
        z = np.zeros(out_size, np.int64)
        return z, z, np.zeros(out_size, np.float32)
    src = np.clip((np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5,
                  0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    return lo, np.minimum(lo + 1, in_size - 1), (src - lo).astype(np.float32)


def resize_bilinear_taps(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the trailing two axes of ``x [..., H, W]`` as two
    taps a position (``index_select`` and a lerp in float32): the same
    half-pixel map as ``resize_bilinear``, in O(out) work a row."""
    dt = x.dtype
    xf = x.float()
    for axis, out_size in ((-2, out_hw[0]), (-1, out_hw[1])):
        in_size = xf.shape[axis]
        if in_size == out_size:
            continue
        lo, hi, frac = (torch.from_numpy(a).to(xf.device) for a in _linear_taps(in_size, out_size))
        a = xf.index_select(xf.ndim + axis, lo)
        b = xf.index_select(xf.ndim + axis, hi)
        w = frac.reshape(-1, 1) if axis == -2 else frac
        xf = (1.0 - w) * a + w * b
    return xf.to(dt)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of the trailing two axes of ``x [..., H, W]`` with
    torch's ``mode="nearest"`` index ``floor(dst * in / out)``."""
    for axis, out_size in ((-2, out_hw[0]), (-1, out_hw[1])):
        in_size = x.shape[axis]
        if in_size == out_size:
            continue
        idx = np.minimum(np.floor(np.arange(out_size) * (in_size / out_size)), in_size - 1)
        x = x.index_select(x.ndim + axis, torch.from_numpy(idx.astype(np.int64)).to(x.device))
    return x
