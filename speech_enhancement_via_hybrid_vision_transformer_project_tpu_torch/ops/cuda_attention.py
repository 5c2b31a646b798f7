"""Scaled dot-product attention of the ViT blocks: CUDA kernel K2, forward
and backward, beside its plain PyTorch version.

``attention`` replaces the JAX package's ``fused_attention``
(``ops/pallas_attention.py``) and its custom VJP. A CPU tensor runs the plain
version (and autograd through it). A CUDA tensor launches the kernels or
raises: with no gradient wanted, the forward (``csrc/attention.cu``: a
flash-attention forward on the tensor cores in 3xTF32); when q, k or v
require grad, the autograd Function ``_Attention``, whose forward is that
kernel (it also writes each row's log-sum-exp) and whose backward is
``csrc/attention_bwd.cu`` (a dq pass and a dk/dv pass, each on the tensor
cores in 3xTF32; the softmax weights recomputed, never stored).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import kernels

_HEAD_DIMS = (16, 32, 64, 128)  # csrc/attention*.cu template instances
NEG_INF = -1e30  # masked-key logit, as sdpa_reference
LOG2E = 1.0 / math.log(2.0)  # the kernels' softmax runs in base 2


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of K2 with ``sdpa_reference`` semantics:
    ``[B, H, N, D]`` in and out, fp32 softmax, masked keys' logits replaced
    by -1e30 (``mask``: ``[B, N]`` bool, True = attend). Autograd through it
    is the plain version of K2's backward: ``masked_fill`` gives a masked
    logit no gradient, as ``jnp.where`` does."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w.to(q.dtype), v).to(q.dtype)


def attention_bwd_plain(q, k, v, dout, *, scale: float, mask=None):
    """Plain version of K2's backward: ``(dq, dk, dv)`` by autograd through
    ``attention_plain`` (``_fused_bwd``'s einsums, derived)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention_plain(*leaves, scale=scale, mask=mask)
        return torch.autograd.grad(out, leaves, dout)


def _check(q, k, v, mask):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"attention: expected q, k, v [B, H, N, D] of one shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, _, n, _ = q.shape
    if mask is not None and (mask.dtype != torch.bool or mask.shape != (b, n)):
        raise ValueError(f"attention: mask must be bool [B, N], got {mask.dtype} {tuple(mask.shape)}")
    tensors = (q, k, v) if mask is None else (q, k, v, mask)
    if any(t.device != q.device for t in tensors):
        raise ValueError("attention: inputs on different devices")


def _check_kernel_inputs(named, d):
    for name, t in named:
        kernels.check_input(f"attention {name}", t, 4)
        if t.data_ptr() % 16:  # float4 loads
            raise ValueError(f"attention {name}: expected a 16-byte aligned tensor")
    if d not in _HEAD_DIMS:
        raise ValueError(f"attention kernel: head dim {d} not in {_HEAD_DIMS}")


def _forward_kernel(q, k, v, scale, mask, with_lse: bool):
    """Launch K2's forward; returns ``(out, lse)``, ``lse`` ``[B*H, N]``
    (log2 units) when ``with_lse``, else None."""
    b, h, n, d = q.shape
    _check_kernel_inputs((("q", q), ("k", k), ("v", v)), d)
    if mask is not None:
        mask = mask.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(b * h, n, device=q.device, dtype=torch.float32) if with_lse else None
    if b * h and n:
        with torch.cuda.device(q.device):
            kernels.launch(
                "attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if mask is None else mask.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                b * h, h, n, d, float(scale) * LOG2E,
            )
    return out, lse


def _backward_kernel(q, k, v, out, lse, dout, scale, mask):
    """Launch K2's backward: ``(dq, dk, dv)`` given what ``_forward_kernel``
    took and made with ``with_lse`` (q, k, v, mask; ``out``, ``lse``) and
    the output's gradient ``dout`` ``[B, H, N, D]``. Under the same
    kept-key-list limit as the forward."""
    b, h, n, d = q.shape
    _check_kernel_inputs((("dout", dout),), d)
    if dout.shape != q.shape:
        raise ValueError(f"attention backward: dout {tuple(dout.shape)}, not q's shape")
    if mask is not None:
        mask = mask.contiguous()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty(b * h, n, device=q.device, dtype=torch.float32)
    if b * h and n:
        with torch.cuda.device(q.device):
            kernels.launch(
                "attention_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), None if mask is None else mask.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                b * h, h, n, d, float(scale) * LOG2E, float(scale),
            )
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """K2 forward and backward on CUDA tensors: the forward saves its output
    and log-sum-exp; the backward recomputes the softmax weights from them."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale):
        q, k, v = (t.detach() for t in (q, k, v))
        out, lse = _forward_kernel(q, k, v, scale, mask, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, mask)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        # the saved output comes back as the graph's tensor, requiring grad
        q, k, v, out, lse, mask = (None if t is None else t.detach() for t in ctx.saved_tensors)
        dq, dk, dv = _backward_kernel(q, k, v, out, lse, dout.detach().contiguous(), ctx.scale,
                                      mask)
        return dq, dk, dv, None, None


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over ``[B, H, N, D]`` tensors with an optional ``[B, N]``
    bool key mask, differentiable. CPU: plain version; CUDA: kernel K2 (and
    its backward when q, k or v require grad), which walks only the keys a
    masked row keeps. Its blocks list those keys in shared memory, 4 bytes a
    key, so a mask over more than about 37,000 keys (head dim 64; fewer in
    the backward, whose A operands and tiles take more: 30,956) does not fit
    and raises."""
    _check(q, k, v, mask)
    if not kernels.uses_kernel(q):
        return attention_plain(q, k, v, scale=scale, mask=mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, mask, scale)
    q, k, v = (t.detach() for t in (q, k, v))  # no gradient wanted (no_grad)
    return _forward_kernel(q, k, v, scale, mask, with_lse=False)[0]


def kernel_info(d: int, n: int, masked: bool = True) -> dict:
    """Registers and local (spill) bytes per thread, shared memory per
    block and resident blocks per SM of K2's instance for head dim ``d``
    at ``n`` keys, as the CUDA runtime reports them (needs the card)."""
    fn = kernels.library()["attention_fwd"].sevit_attention_info
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in range(4)]
    err = fn(d, n, int(masked), *(ctypes.byref(x) for x in vals))
    if err != 0:
        raise RuntimeError(f"sevit_attention_info failed with error {err}")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"),
                    (x.value for x in vals)))


def bwd_kernel_info(d: int) -> dict:
    """Registers and local (spill) bytes per thread of K2 backward's dq pass
    and dk/dv pass for head dim ``d`` (needs the card)."""
    fn = kernels.library()["attention_bwd"].sevit_attention_bwd_info
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int * 2), ctypes.POINTER(ctypes.c_int * 2)]
    fn.restype = ctypes.c_int
    regs, local = (ctypes.c_int * 2)(), (ctypes.c_int * 2)()
    err = fn(d, ctypes.byref(regs), ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"sevit_attention_bwd_info failed with error {err}")
    return {"dq": {"registers": regs[0], "local_bytes": local[0]},
            "dkdv": {"registers": regs[1], "local_bytes": local[1]}}
