"""Mamba-1's selective scan over length-masked sequences, in either
direction: the 16 scans a forward of SEMamba's TFMamba blocks, CUDA kernel
``selective_scan`` (``csrc/selective_scan.cu``), beside its plain PyTorch
version.

``selective_scan`` computes, for each sequence ``g``, channel ``d`` and
state ``n``, from a zero state,
``delta_t = softplus(delta_t + delta_bias)``,
``h_t = exp(delta_t A) h_{t-1} + delta_t B_t u_t`` with ``A = -exp(A_log)``
and ``y_t = (C_t . h_t + D u_t) * silu(z_t)``, over the sequence's first
``n_valid[g]`` steps in order, or with ``reverse`` from step ``n_valid[g] -
1`` down to 0; ``y`` is 0 at the steps from ``n_valid[g]`` on. That is
mamba_ssm's ``selective_scan_fn(u, delta, A, B, C, D, z, delta_bias,
delta_softplus=True)`` on each valid prefix, reversed where asked, forward
only, through the op ``torch.ops.sevit.selective_scan``. On a CPU tensor the
op runs the plain version, a sequential loop over the steps; on a CUDA
tensor it launches the kernel, fp32, within rounding of the plain version.

Layout token-major, as the model's linear layers leave it: ``u``, ``delta``
``[G, L, D]`` contiguous; ``z`` ``[G, L, D]`` and ``B``, ``C`` ``[G, L, N]``
may be strided views of larger rows (the in_proj and x_proj outputs), each
with unit stride along its last axis; the kernel reads them in place.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import kernels

STATES = (16,)  # the d_state values the kernel is built for: the published one


def selective_scan_plain(u, delta, z, B, C, A_log, D, delta_bias, n_valid=None,
                         reverse: bool = False):
    """Plain version: the recurrence as a loop over the steps, every
    sequence at once; a step at or past a sequence's ``n_valid`` leaves its
    state as it is (so the reverse loop, from the last step down, starts
    each sequence at its last valid step from a zero state) and its output
    0. Computes in ``u``'s dtype."""
    g, length, d = u.shape
    dt = F.softplus(delta + delta_bias)
    a = -torch.exp(A_log)
    h = u.new_zeros(g, d, A_log.shape[1])
    ys = u.new_zeros(g, length, d)
    active = None
    if n_valid is not None:
        active = torch.arange(length, device=u.device)[None, :] < n_valid.to(u.device)[:, None]
    for t in (range(length - 1, -1, -1) if reverse else range(length)):
        step = torch.exp(dt[:, t, :, None] * a) * h + (dt[:, t] * u[:, t])[:, :, None] * \
            B[:, t, None, :]
        h = step if active is None else torch.where(active[:, t, None, None], step, h)
        ys[:, t] = (h * C[:, t, None, :]).sum(-1)
    out = (ys + u * D) * F.silu(z)
    return out if active is None else out * active[..., None].to(out.dtype)


def _check(u, delta, z, B, C, A_log, D, delta_bias, n_valid):
    if u.dim() != 3:
        raise ValueError(f"selective_scan: u must be [G, L, D], got {tuple(u.shape)}")
    g, length, d = u.shape
    n = A_log.shape[-1] if A_log.dim() == 2 else -1
    for name, t, want in (("delta", delta, (g, length, d)), ("z", z, (g, length, d)),
                          ("B", B, (g, length, n)), ("C", C, (g, length, n)),
                          ("A_log", A_log, (d, n)), ("D", D, (d,)),
                          ("delta_bias", delta_bias, (d,))):
        if tuple(t.shape) != want:
            raise ValueError(f"selective_scan: {name} must be {list(want)}, got "
                             f"{tuple(t.shape)}")
    if n_valid is not None and (n_valid.shape != (g,) or n_valid.dtype != torch.int32):
        raise ValueError(f"selective_scan: n_valid must be int32 [{g}], got {n_valid.dtype} "
                         f"{tuple(n_valid.shape)}")
    if any(t is not None and t.device != u.device
           for t in (delta, z, B, C, A_log, D, delta_bias, n_valid)):
        raise ValueError("selective_scan: inputs on different devices")


def _rows(name: str, t: torch.Tensor) -> int:
    """The token stride of a ``[G, L, K]`` view whose tokens lie at one
    stride and whose sequences follow each other (``stride(0) = L *
    stride(1)``), each token's K floats contiguous."""
    if t.dtype != torch.float32:
        raise TypeError(f"selective_scan {name}: expected float32, got {t.dtype}")
    if t.stride(2) != 1 or t.stride(0) != t.shape[1] * t.stride(1):
        raise ValueError(f"selective_scan kernel: {name} must be rows of tokens, got strides "
                         f"{t.stride()}")
    return t.stride(1)


def _kernel(u, delta, z, B, C, A_log, D, delta_bias, n_valid, reverse):
    """Launch the kernel (the op's CUDA impl)."""
    _check(u, delta, z, B, C, A_log, D, delta_bias, n_valid)
    g, length, d = u.shape
    states = A_log.shape[1]
    if states not in STATES:
        raise ValueError(f"selective_scan kernel: d_state {states} not in {STATES}")
    for name, t in (("u", u), ("delta", delta)):
        kernels.check_input(f"selective_scan {name}", t, 3)
    for name, t in (("A_log", A_log), ("D", D), ("delta_bias", delta_bias)):
        # a parameter's requires_grad: the wrapper refuses a gradient
        kernels.check_input(f"selective_scan {name}", t, t.dim(), differentiable=True)
    z_stride = _rows("z", z)
    bc_stride = _rows("B", B)
    if _rows("C", C) != bc_stride or bc_stride % 4 or any(
            t.data_ptr() % 16 for t in (B, C)):
        # the kernel reads B and C as float4 rows at one stride
        bc = torch.cat([B, C], dim=-1)
        B, C, bc_stride = bc[..., :states], bc[..., states:], 2 * states
    if n_valid is not None and not n_valid.is_contiguous():
        raise ValueError("selective_scan kernel: n_valid must be contiguous")
    y = torch.empty_like(u)
    if y.numel():
        with torch.cuda.device(u.device):
            kernels.launch(
                "selective_scan", u.data_ptr(), delta.data_ptr(), z.data_ptr(), B.data_ptr(),
                C.data_ptr(), A_log.data_ptr(), D.data_ptr(), delta_bias.data_ptr(),
                None if n_valid is None else n_valid.data_ptr(), y.data_ptr(), g, length, d,
                states, z_stride, bc_stride, int(reverse),
            )
    return y


def _plain_op(u, delta, z, B, C, A_log, D, delta_bias, n_valid, reverse):
    _check(u, delta, z, B, C, A_log, D, delta_bias, n_valid)
    return selective_scan_plain(u, delta, z, B, C, A_log, D, delta_bias, n_valid, reverse)


def _fake(u, delta, z, B, C, A_log, D, delta_bias, n_valid, reverse):
    return torch.empty_like(u)


selective_scan_op = kernels.define_op(
    "selective_scan",
    "(Tensor u, Tensor delta, Tensor z, Tensor B, Tensor C, Tensor A_log, Tensor D,"
    " Tensor delta_bias, Tensor? n_valid, bool reverse) -> Tensor",
    cpu=_plain_op, cuda=_kernel, fake=_fake)


def selective_scan(u: torch.Tensor, delta: torch.Tensor, z: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                   delta_bias: torch.Tensor, n_valid: Optional[torch.Tensor] = None,
                   reverse: bool = False) -> torch.Tensor:
    """``y [G, L, D]`` of the selective scan (the module docstring) of ``u``,
    ``delta`` (before the softplus and its bias), ``z`` ``[G, L, D]``, ``B``,
    ``C`` ``[G, L, N]``, ``A_log [D, N]``, ``D``, ``delta_bias [D]``;
    ``n_valid`` int32 ``[G]`` on u's device (None: every step valid).
    Forward only: refuses a gradient."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u, delta, z, B, C, A_log, D, delta_bias)):
        raise RuntimeError("selective_scan: forward only (the kernel has no backward); run "
                           "under torch.no_grad() or torch.inference_mode()")
    return selective_scan_op(u, delta, z, B, C, A_log, D, delta_bias, n_valid, bool(reverse))
