"""Mamba-1's sequence mixing in either direction: the 16 Mamba layers a
forward of SEMamba's TFMamba blocks, each a depthwise conv with its SiLU
(CUDA kernel ``conv1d_silu``, ``csrc/conv1d_silu.cu``) and a selective scan
over length-masked sequences (CUDA kernel ``selective_scan``,
``csrc/selective_scan.cu``), each beside its plain PyTorch version.

``conv1d_silu`` computes ``u = silu(conv1d(x) + bias)``, depthwise, over
``x [G, L, D]``: the causal conv (padded ``k - 1`` steps on the left, as
mamba_ssm's), or with ``reverse`` the mirrored one (padded on the right,
the kernel flipped: the causal conv of the flipped sequence, flipped back).
Every step is computed. ``x`` may be a strided view of larger rows (the
in_proj output's first half), with unit stride along its last axis; the
kernel reads it in place and writes ``u`` contiguous, through the op
``torch.ops.sevit.conv1d_silu``.

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

STATES = (16,)  # the d_state values the scan kernel is built for: the published one
WIDTHS = (4,)  # the conv widths the conv kernel is built for: the published d_conv


def conv1d_silu_plain(x, weight, bias, reverse: bool = False):
    """Plain version: ATen's padded transposed copy, depthwise conv,
    transpose back and SiLU."""
    k = weight.shape[-1]
    xp = F.pad(x.transpose(1, 2), (0, k - 1) if reverse else (k - 1, 0))
    u = F.conv1d(xp, weight.flip(-1) if reverse else weight, bias, groups=weight.shape[0])
    return F.silu(u.transpose(1, 2).contiguous(), inplace=True)


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


def _rows(op: str, name: str, t: torch.Tensor) -> int:
    """The token stride of a ``[G, L, K]`` view whose tokens lie at one
    stride and whose sequences follow each other (``stride(0) = L *
    stride(1)``), each token's K floats contiguous. The stride of an axis
    of size 1 is never stepped, so it may be anything (``.contiguous()``
    keeps it)."""
    if t.dtype != torch.float32:
        raise TypeError(f"{op} {name}: expected float32, got {t.dtype}")
    g, length, k = t.shape
    token = t.stride(1) if length > 1 else t.stride(0) if g > 1 else k
    if (k > 1 and t.stride(2) != 1) or (g > 1 and t.stride(0) != length * token):
        raise ValueError(f"{op} kernel: {name} must be rows of tokens, got strides "
                         f"{t.stride()}")
    return token


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
    z_stride = _rows("selective_scan", "z", z)
    bc_stride = _rows("selective_scan", "B", B)
    if _rows("selective_scan", "C", C) != bc_stride or bc_stride % 4 or any(
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


def _check_conv(x, weight, bias):
    if x.dim() != 3:
        raise ValueError(f"conv1d_silu: x must be [G, L, D], got {tuple(x.shape)}")
    d = x.shape[-1]
    if weight.dim() != 3 or tuple(weight.shape[:2]) != (d, 1) or tuple(bias.shape) != (d,):
        raise ValueError(f"conv1d_silu: weight must be [{d}, 1, k] and bias [{d}], got "
                         f"{tuple(weight.shape)} and {tuple(bias.shape)}")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("conv1d_silu: inputs on different devices")


def _conv_kernel(x, weight, bias, reverse):
    """Launch the kernel (the op's CUDA impl): x read in place."""
    _check_conv(x, weight, bias)
    g, length, d = x.shape
    width = weight.shape[-1]
    if width not in WIDTHS:
        raise ValueError(f"conv1d_silu kernel: width {width} not in {WIDTHS}")
    x_stride = _rows("conv1d_silu", "x", x)
    for name, t in (("weight", weight), ("bias", bias)):
        # a parameter's requires_grad: the wrapper refuses a gradient
        kernels.check_input(f"conv1d_silu {name}", t, t.dim(), differentiable=True)
    u = torch.empty(g, length, d, device=x.device, dtype=x.dtype)
    if u.numel():
        with torch.cuda.device(x.device):
            kernels.launch("conv1d_silu", x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                           u.data_ptr(), g, length, d, width, x_stride, int(reverse))
    return u


def _conv_plain_op(x, weight, bias, reverse):
    _check_conv(x, weight, bias)
    return conv1d_silu_plain(x, weight, bias, reverse)


def _conv_fake(x, weight, bias, reverse):
    return x.new_empty(x.shape)


conv1d_silu_op = kernels.define_op(
    "conv1d_silu", "(Tensor x, Tensor weight, Tensor bias, bool reverse) -> Tensor",
    cpu=_conv_plain_op, cuda=_conv_kernel, fake=_conv_fake)


def conv1d_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                reverse: bool = False) -> torch.Tensor:
    """``u [G, L, D]`` contiguous, ``silu`` of the depthwise conv of ``x [G,
    L, D]`` with ``weight [D, 1, k]`` and ``bias [D]``: causal, or with
    ``reverse`` mirrored (the module docstring). Forward only: refuses a
    gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        raise RuntimeError("conv1d_silu: forward only (the kernel has no backward); run "
                           "under torch.no_grad() or torch.inference_mode()")
    return conv1d_silu_op(x, weight, bias, bool(reverse))
