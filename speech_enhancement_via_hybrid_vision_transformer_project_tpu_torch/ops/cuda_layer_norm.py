"""A residual add and a LayerNorm in one pass: the sublayer boundaries of
CMGAN's conformer blocks, CUDA kernel ``add_layer_norm``
(``csrc/add_layer_norm.cu``), beside its plain PyTorch version.

``add_layer_norm`` computes ``s = x + scale * delta`` and ``h =
LayerNorm(s) (+ residual)`` over ``[G, N, C]`` rows, forward only, through
the op ``torch.ops.sevit.add_layer_norm``. On a CPU tensor the op runs the
plain version: the ATen calls the conformer block makes for the same
arithmetic unfused (``delta * scale``, ``+ x``, ``F.layer_norm``, ``+
residual``), so a CPU forward equals the unfused one bit for bit. On a CUDA
tensor it launches the kernel (C = 64, CMGAN's width), which stores the
same ``s`` and ``h`` within fp32 rounding of the LayerNorm's sums.

``delta`` is ``[G, N, C]``, or ``[G, C, N]`` where ``channels_first`` (the
convolution module's output before its last transpose); the kernel reads
either layout from device memory once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import kernels

CHANNELS = 64  # the kernel's row width (csrc/add_layer_norm.cu)


def add_layer_norm_plain(x, delta, weight, bias, eps: float, *, scale: float = 1.0,
                         channels_first: bool = False, residual=None):
    """Plain version: ``(s, h)``, ``s = delta * scale + x`` (``x`` where
    ``delta`` is None; no product where ``scale`` is 1) and ``h =
    F.layer_norm(s) + residual``, in the order the unfused block rounds
    them."""
    s = x
    if delta is not None:
        d = delta.transpose(1, 2) if channels_first else delta
        if scale != 1.0:
            d = d * scale
        s = d + x
    h = F.layer_norm(s, (s.shape[-1],), weight, bias, eps)
    if residual is not None:
        h = h + residual
    return s, h


def _check(x, delta, weight, bias, channels_first, residual, keep_sum):
    if x.dim() != 3:
        raise ValueError(f"add_layer_norm: x must be [G, N, C], got {tuple(x.shape)}")
    g, n, c = x.shape
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"add_layer_norm: weight and bias must be [{c}]")
    if delta is not None:
        want = (g, c, n) if channels_first else (g, n, c)
        if tuple(delta.shape) != want:
            raise ValueError(f"add_layer_norm: delta must be {list(want)}, got "
                             f"{tuple(delta.shape)}")
    elif channels_first or keep_sum:
        raise ValueError("add_layer_norm: channels_first and keep_sum need a delta")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"add_layer_norm: residual must be {tuple(x.shape)}")
    if any(t is not None and t.device != x.device for t in (delta, weight, bias, residual)):
        raise ValueError("add_layer_norm: inputs on different devices")


def _kernel(x, delta, weight, bias, eps, scale, channels_first, residual, keep_sum):
    """Launch the kernel (the op's CUDA impl)."""
    _check(x, delta, weight, bias, channels_first, residual, keep_sum)
    g, n, c = x.shape
    if c != CHANNELS:
        raise ValueError(f"add_layer_norm kernel: C = {c}, the kernel takes {CHANNELS}")
    if g * n > 2**31 - 1:
        raise ValueError(f"add_layer_norm kernel: {g * n} rows, at most 2^31 - 1")
    named = [("x", x, 3), ("weight", weight, 1), ("bias", bias, 1)]
    named += [(name, t, 3) for name, t in (("delta", delta), ("residual", residual))
              if t is not None]
    for name, t, ndim in named:  # (a parameter's requires_grad: the wrapper refuses a gradient)
        kernels.check_input(f"add_layer_norm {name}", t, ndim, differentiable=True)
        if t.data_ptr() % 16 and not (name == "delta" and channels_first):
            raise ValueError(f"add_layer_norm kernel: {name} is not 16-byte aligned")
    out = torch.empty_like(x)
    s = torch.empty_like(x) if keep_sum else x.new_empty(0)
    if g * n:
        with torch.cuda.device(x.device):
            kernels.launch(
                "add_layer_norm", x.data_ptr(), None if delta is None else delta.data_ptr(),
                None if residual is None else residual.data_ptr(), weight.data_ptr(),
                bias.data_ptr(), s.data_ptr() if keep_sum else None, out.data_ptr(), g, n,
                float(scale), float(eps), int(channels_first),
            )
    return s, out


def _plain_op(x, delta, weight, bias, eps, scale, channels_first, residual, keep_sum):
    _check(x, delta, weight, bias, channels_first, residual, keep_sum)
    s, h = add_layer_norm_plain(x, delta, weight, bias, eps, scale=scale,
                                channels_first=channels_first, residual=residual)
    return (s.contiguous() if keep_sum else x.new_empty(0)), h


def _fake(x, delta, weight, bias, eps, scale, channels_first, residual, keep_sum):
    return (torch.empty_like(x) if keep_sum else x.new_empty(0)), torch.empty_like(x)


add_layer_norm_op = kernels.define_op(
    "add_layer_norm",
    "(Tensor x, Tensor? delta, Tensor weight, Tensor bias, float eps, float scale,"
    " bool channels_first, Tensor? residual, bool keep_sum) -> (Tensor, Tensor)",
    cpu=_plain_op, cuda=_kernel, fake=_fake)


def add_layer_norm(x: torch.Tensor, delta: Optional[torch.Tensor], weight: torch.Tensor,
                   bias: torch.Tensor, eps: float, *, scale: float = 1.0,
                   channels_first: bool = False, residual: Optional[torch.Tensor] = None,
                   keep_sum: bool = False) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """``(s, h)``: ``s = x + scale * delta`` where ``keep_sum`` (else None;
    it needs a delta) and ``h = LayerNorm(s; weight, bias, eps)``, plus
    ``residual`` where given. ``x``, ``residual`` ``[G, N, C]``; ``delta``
    ``[G, N, C]`` or, where ``channels_first``, ``[G, C, N]``; None for
    ``h = LayerNorm(x)``. Forward only: refuses a gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, delta, weight, bias, residual)):
        raise RuntimeError("add_layer_norm: forward only (the kernel has no backward); run "
                           "under torch.no_grad() or torch.inference_mode()")
    s, h = add_layer_norm_op(x, delta, weight, bias, float(eps), float(scale),
                             bool(channels_first), residual, bool(keep_sum))
    return (s if keep_sum else None), h
