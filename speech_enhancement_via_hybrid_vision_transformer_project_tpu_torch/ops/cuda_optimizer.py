"""The optimizer's chain over every parameter tensor at once: the CUDA
kernels ``global_sq_norm`` and ``adam_update`` (``csrc/optimizer.cu``)
beside their plain PyTorch versions.

``global_norm(tensors)`` is ``optax.global_norm``: sqrt of the sum of every
element's square. ``adam_update(...)`` is ``clip_by_global_norm`` then
``adam`` or ``adamw`` with optax's arithmetic (``training/optimizer.py``
has the formulas), updating the parameters and both moments in place.

Dispatch: CPU tensors take the plain versions, the per-tensor loops the
port ran before the kernels. CUDA tensors that are fp32 and dense (no gaps:
contiguous, or with their dims in another order), all on one device, launch
the kernel (one launch per ``*_MAX`` tensors); any other input raises, never
computed by the plain version. ``adam_update`` takes p, m and v in one
layout; a gradient in another is copied to its parameter's first. The kernels are
called directly rather than through a ``torch.library`` op: they update
tensor lists in place and belong to no exported program.

``global_sq_norm`` sums in double, so its result differs from the plain
version's fp32 sums in the last bits; it is deterministic. ``adam_update``
rounds op by op as the plain loop's CUDA kernels do, so with the same norm
(or no clip) its p, m and v equal the plain version's on the card bit for
bit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import kernels

NORM_CHUNK = 8192  # csrc/optimizer.cu NORM_CHUNK: elements a block
ADAM_CHUNK = 4096  # ADAM_CHUNK
NORM_MAX = 1024  # NORM_MAX: tensors a launch
ADAM_MAX = 512  # ADAM_MAX

_counters: dict = {}  # (device index, stream) -> the norm kernel's block counter
# numels and p, m, v pointer tables whose tensors were checked: p, m and v
# stay put from step to step, and their per-tensor checks cost 0.40-0.54 ms a
# step at 110-182 tensors on an H100 host, a quarter of the update's host time
_checked: set = set()


def global_norm_plain(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version of ``global_sq_norm``: fp32 sums, tensor by tensor."""
    return torch.sqrt(sum(torch.sum(g * g) for g in tensors))


def clip_plain(grads: Sequence[torch.Tensor], g_norm: torch.Tensor,
               max_norm: float) -> list:
    """``clip_by_global_norm``: ``g / g_norm * max_norm`` where ``g_norm >=
    max_norm`` (no epsilon), decided on the device."""
    clip = g_norm >= max_norm
    return [torch.where(clip, g / g_norm * max_norm, g) for g in grads]


def bias_corrections(b1: float, b2: float, count: int) -> tuple:
    """``(1 - b1^count, 1 - b2^count)`` in float64: 1 - b2^count cancels, so
    optax's float32 power is off by up to ~3e-5 of it at count 3."""
    return 1.0 - b1**count, 1.0 - b2**count


def adam_update_plain(params, grads, mu, nu, *, lr: float, b1: float, b2: float, eps: float,
                      weight_decay: float, adamw: bool, count: int,
                      g_norm: Optional[torch.Tensor] = None,
                      max_norm: Optional[float] = None) -> None:
    """Plain version of ``adam_update``: the clip (with ``max_norm``) and
    one Adam or AdamW step at ``count`` (already incremented), tensor by
    tensor, in place."""
    if max_norm is not None:
        grads = clip_plain(grads, g_norm, max_norm)
    c1, c2 = bias_corrections(b1, b2, count)
    for p, g, m, v in zip(params, grads, mu, nu):
        m.copy_((1 - b1) * g + b1 * m)
        v.copy_((1 - b2) * (g * g) + b2 * v)
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        if adamw:
            u = u + weight_decay * p
        p.add_(-lr * u)


def _dense(t: torch.Tensor) -> bool:
    """True where ``t`` fills ``numel`` consecutive elements from its data
    pointer, its dims in any order (a transposed or channels-last tensor)."""
    if t.is_contiguous():
        return True
    expected = 1
    for size, stride in sorted(((n, s) for n, s in zip(t.shape, t.stride()) if n != 1),
                               key=lambda d: d[1]):
        if stride != expected:
            return False
        expected *= size
    return True


def _check_cuda(name: str, t: torch.Tensor, device: torch.device) -> None:
    """Raise unless ``t`` is fp32 and dense on ``device``."""
    if t.device != device:
        raise ValueError(f"{name}: tensors on {t.device} and {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if not _dense(t):
        raise ValueError(f"{name}: expected dense tensors (no gaps, no overlaps)")


def _pointers(tensors: Sequence[torch.Tensor]) -> np.ndarray:
    return np.fromiter((t.data_ptr() for t in tensors), np.int64, len(tensors))


def _counter(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    c = _counters.get(key)
    if c is None:
        c = _counters[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return c


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum x^2) over every element of ``tensors``, a 0-d fp32 tensor
    on their device: the plain version on the CPU, one ``global_sq_norm``
    launch on CUDA (per ``NORM_MAX`` tensors)."""
    tensors = list(tensors)
    if not kernels.uses_kernel(tensors[0]):
        return global_norm_plain(tensors)
    device = tensors[0].device
    for t in tensors:
        _check_cuda("global_sq_norm", t, device)
    out = torch.empty((), dtype=torch.float32, device=device)
    tensors = [t for t in tensors if t.numel() > 0]
    if not tensors:
        return out.zero_()
    numel = np.array([t.numel() for t in tensors], np.int64)
    blocks = -(-numel // NORM_CHUNK)
    total = int(blocks.sum())
    partials = torch.empty(total, dtype=torch.float64, device=device)
    counter = _counter(device, torch.cuda.current_stream(device).cuda_stream)
    ptrs = _pointers(tensors)
    with torch.cuda.device(device):
        for lo in range(0, len(tensors), NORM_MAX):
            hi = min(lo + NORM_MAX, len(tensors))
            kernels.launch("global_sq_norm", ptrs[lo:hi].ctypes.data, numel[lo:hi].ctypes.data,
                           hi - lo, NORM_CHUNK, partials.data_ptr(), counter.data_ptr(),
                           out.data_ptr(), int(blocks[:lo].sum()), total)
    return out


def adam_update(params, grads, mu, nu, *, lr: float, b1: float, b2: float, eps: float,
                weight_decay: float, adamw: bool, count: int,
                g_norm: Optional[torch.Tensor] = None,
                max_norm: Optional[float] = None) -> bool:
    """One Adam (``adamw`` False) or AdamW step at ``count`` (already
    incremented) over every tensor, in place, clipped by ``g_norm`` (a 0-d
    tensor on the parameters' device) where ``max_norm`` is given. CPU
    tensors take ``adam_update_plain``; CUDA tensors one ``adam_update``
    launch (per ``ADAM_MAX`` tensors), which reads the norm on the device.
    Returns True when it launched the kernel."""
    params, grads, mu, nu = (list(x) for x in (params, grads, mu, nu))
    if max_norm is not None and g_norm is None:
        raise ValueError("adam_update: max_norm given without g_norm")
    if not kernels.uses_kernel(params[0]):
        adam_update_plain(params, grads, mu, nu, lr=lr, b1=b1, b2=b2, eps=eps,
                          weight_decay=weight_decay, adamw=adamw, count=count, g_norm=g_norm,
                          max_norm=max_norm)
        return False
    device = params[0].device
    if not len(params) == len(grads) == len(mu) == len(nu):
        raise ValueError("adam_update: tensor lists of different lengths")
    if max_norm is not None:
        _check_cuda("adam_update g_norm", g_norm, device)
        if g_norm.numel() != 1:
            raise ValueError("adam_update: g_norm must be one element")
    keep = [i for i, p in enumerate(params) if p.numel() > 0]
    if not keep:
        return True
    params, grads, mu, nu = ([x[i] for i in keep] for x in (params, grads, mu, nu))
    numel = np.array([p.numel() for p in params], np.int64)
    state = [_pointers(x) for x in (params, mu, nu)]
    key = b"".join(t.tobytes() for t in (numel, *state))
    if key not in _checked:
        for p, m, v in zip(params, mu, nu):
            for t in (p, m, v):
                _check_cuda("adam_update", t, device)
            if not (p.shape == m.shape == v.shape and p.stride() == m.stride() == v.stride()):
                raise ValueError("adam_update: moments shaped or laid out otherwise than "
                                 "their parameter")
        if len(_checked) >= 16:
            _checked.clear()
        _checked.add(key)
    for i, (p, g) in enumerate(zip(params, grads)):
        if g.dtype != torch.float32 or g.device != device or g.shape != p.shape:
            _check_cuda("adam_update", g, device)
            raise ValueError(f"adam_update: gradient {tuple(g.shape)} for {tuple(p.shape)}")
        if g.stride() != p.stride():
            _check_cuda("adam_update", g, device)
            # cuDNN may hand back a weight's gradient in another layout
            grads[i] = torch.empty_like(p).copy_(g)
    tables = [state[0], _pointers(grads), *state[1:]]
    c1, c2 = bias_corrections(b1, b2, count)
    f32 = np.float32
    # the fp32 values the plain loop's ops use: a host scalar is cast to fp32,
    # and ATen divides by one as a product with its reciprocal, taken in
    # double and then cast
    scalars = [float(f32(x)) for x in (
        max_norm if max_norm is not None else 0.0, b1, 1 - b1, b2, 1 - b2,
        1.0 / c1, 1.0 / c2, eps, weight_decay, -lr)]
    norm_ptr = g_norm.data_ptr() if max_norm is not None else None
    with torch.cuda.device(device):
        for lo in range(0, len(params), ADAM_MAX):
            hi = min(lo + ADAM_MAX, len(params))
            kernels.launch("adam_update", *(t[lo:hi].ctypes.data for t in tables),
                           numel[lo:hi].ctypes.data, hi - lo, ADAM_CHUNK, norm_ptr, *scalars,
                           int(adamw))
    return True
