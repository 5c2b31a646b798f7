"""Scaled dot-product attention of the ViT blocks: CUDA kernel K2, forward
and backward, beside its plain PyTorch version.

``attention`` replaces the JAX package's ``fused_attention``
(``ops/pallas_attention.py``) and its custom VJP. It calls the op
``torch.ops.sevit.attention_fwd`` on both devices. On a CPU tensor the op
runs the plain version; on a CUDA tensor it launches the forward kernel
(``csrc/attention.cu``: a flash-attention forward on the tensor cores in
3xTF32) or raises. The op's gradient (``torch.library.register_autograd``)
is the op ``torch.ops.sevit.attention_bwd``: on the CPU the plain version of
``_fused_bwd``'s einsums, on CUDA ``csrc/attention_bwd.cu`` (a dq pass and a
dk/dv pass, each on the tensor cores in 3xTF32; the softmax weights
recomputed from the forward's log-sum-exp, never stored).

The kernels have instances for head dims 16, 32, 64 and 128, and a sliced
one for head dims above 128: D in slices of 128 columns, a block per output
slice, each summing ``QK^T`` (and, in the backward, ``dO V^T``) over every
slice. Any other head dim runs the next larger instance, or the next multiple
of 128 above 128 (``kernel_head_dim``): q, k and v are zero-padded along D and
the output cropped, and in the backward the output's gradient is padded and
dq, dk and dv cropped. Zero columns leave ``QK^T`` and the log-sum-exp as they
are and give zero output and gradient columns.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import kernels

_HEAD_DIMS = (16, 32, 64, 128)  # csrc/attention*.cu template instances
SLICE = 128  # columns of a slice of the sliced instance, above the largest
NEG_INF = -1e30  # masked-key logit, as sdpa_reference
LOG2E = 1.0 / math.log(2.0)  # the kernels' softmax runs in base 2


def _logits(q, k, scale, mask):
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    return logits


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
    by -1e30 (``mask``: ``[B, N]`` bool, True = attend). Differentiable:
    ``masked_fill`` gives a masked logit no gradient, as ``jnp.where``
    does."""
    w = torch.softmax(_logits(q, k, scale, mask), dim=-1)
    return torch.matmul(w.to(q.dtype), v).to(q.dtype)


def attention_bwd_plain(q, k, v, dout, *, scale: float, mask=None):
    """Plain version of K2's backward: ``(dq, dk, dv)`` of
    ``attention_plain``, as ``_fused_bwd``'s einsums compute them (the
    weights recomputed; a masked logit is a constant and passes no
    gradient, so a masked key gets no dk)."""
    w = torch.softmax(_logits(q, k, scale, mask), dim=-1)
    go = dout.float()
    dv = torch.matmul(w.transpose(-1, -2), go)
    dw = torch.matmul(go, v.float().transpose(-1, -2))
    dlogits = w * (dw - torch.sum(dw * w, dim=-1, keepdim=True))
    if mask is not None:
        dlogits = dlogits.masked_fill(~mask[:, None, None, :], 0.0)
    dq = torch.matmul(dlogits, k.float()) * scale
    dk = torch.matmul(dlogits.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def kernel_head_dim(d: int) -> int:
    """The head dim K2 runs head dim ``d`` at: the smallest of
    ``_HEAD_DIMS`` that holds it, or above 128 the next multiple of
    ``SLICE`` (the sliced instance, ``d / 128`` slices rounded up). Needs no
    card."""
    if d < 1:
        raise ValueError(f"attention kernel: head dim {d}")
    for inst in _HEAD_DIMS:
        if d <= inst:
            return inst
    return -(-d // SLICE) * SLICE


def _pad_head_dim(t: torch.Tensor, dp: int) -> torch.Tensor:
    """``t [..., D]`` with zero columns up to ``dp``."""
    return t if t.shape[-1] == dp else F.pad(t, (0, dp - t.shape[-1])).contiguous()


def _check_kernel_inputs(named, d):
    """What K2 takes, shapes and types only (no storage is read: these
    checks also run while ``torch.export`` traces)."""
    for name, t in named:
        kernels.check_input(f"attention {name}", t, 4, differentiable=True)
    kernel_head_dim(d)


def _check_aligned(named):
    for name, t in named:
        if t.data_ptr() % 16:  # float4 loads
            raise ValueError(f"attention {name}: expected a 16-byte aligned tensor")


def _forward_kernel(q, k, v, mask, scale, with_lse: bool):
    """Launch K2's forward (the op's CUDA impl); returns ``(out, lse)``,
    ``lse`` ``[B*H, N]`` (log2 units) when ``with_lse``, else an empty
    tensor (the kernel then writes none)."""
    b, h, n, d = q.shape
    named = (("q", q), ("k", k), ("v", v))
    _check_kernel_inputs(named, d)
    _check_aligned(named)
    if mask is not None:
        mask = mask.contiguous()
    dp = kernel_head_dim(d)
    q, k, v = (_pad_head_dim(t, dp) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty(b * h, n, device=q.device, dtype=torch.float32) if with_lse else None
    if b * h and n:
        with torch.cuda.device(q.device):
            kernels.launch(
                "attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if mask is None else mask.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                b * h, h, n, dp, float(scale) * LOG2E,
            )
    if dp != d:
        out = out[..., :d].contiguous()
    return out, (q.new_empty(0) if lse is None else lse)


def _backward_kernel(q, k, v, out, lse, dout, mask, scale):
    """Launch K2's backward (the op's CUDA impl): ``(dq, dk, dv)`` given
    what ``_forward_kernel`` took and made with ``with_lse`` (q, k, v, mask;
    ``out``, ``lse``) and the output's gradient ``dout`` ``[B, H, N, D]``.
    Under the same kept-key-list limit as the forward."""
    b, h, n, d = q.shape
    named = (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout))
    _check_kernel_inputs(named, d)
    _check_aligned(named)
    if dout.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"attention backward: out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, not q's shape")
    if lse.shape != (b * h, n):
        raise ValueError(f"attention backward: lse {tuple(lse.shape)}, not [B*H, N]: the "
                         "forward ran without with_lse")
    if mask is not None:
        mask = mask.contiguous()
    dp = kernel_head_dim(d)
    q, k, v, out, dout = (_pad_head_dim(t, dp) for t in (q, k, v, out, dout))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty(b * h, n, device=q.device, dtype=torch.float32)
    if b * h and n:
        with torch.cuda.device(q.device):
            kernels.launch(
                "attention_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), None if mask is None else mask.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                b * h, h, n, dp, float(scale) * LOG2E, float(scale),
            )
    if dp != d:
        dq, dk, dv = (t[..., :d].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


# ---------------------------------------------------------------------------
# The ops: sevit::attention_fwd and sevit::attention_bwd
# ---------------------------------------------------------------------------


def _fwd_plain(q, k, v, mask, scale, with_lse):
    out = attention_plain(q, k, v, scale=scale, mask=mask)
    if not with_lse:
        return out, q.new_empty(0, dtype=torch.float32)
    b, h, n, _ = q.shape
    lse = torch.logsumexp(_logits(q, k, scale, mask), dim=-1) * LOG2E
    return out, lse.reshape(b * h, n)


def _fwd_fake(q, k, v, mask, scale, with_lse):
    b, h, n, _ = q.shape
    return torch.empty_like(q), q.new_empty((b * h, n) if with_lse else (0,),
                                            dtype=torch.float32)


attention_fwd_op = kernels.define_op(
    "attention_fwd",
    "(Tensor q, Tensor k, Tensor v, Tensor? mask, float scale, bool with_lse)"
    " -> (Tensor, Tensor)",
    cpu=_fwd_plain, cuda=_forward_kernel, fake=_fwd_fake)


def _bwd_plain(q, k, v, out, lse, dout, mask, scale):
    return attention_bwd_plain(q, k, v, dout, scale=scale, mask=mask)


def _bwd_fake(q, k, v, out, lse, dout, mask, scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


attention_bwd_op = kernels.define_op(
    "attention_bwd",
    "(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, Tensor dout, Tensor? mask,"
    " float scale) -> (Tensor, Tensor, Tensor)",
    cpu=_bwd_plain, cuda=_backward_kernel, fake=_bwd_fake)


def _setup_context(ctx, inputs, output):
    q, k, v, mask, scale, with_lse = inputs
    out, lse = output
    if not with_lse:
        raise RuntimeError("sevit::attention_fwd: a gradient needs the log-sum-exp: "
                           "call it with with_lse=True")
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, out, lse, mask)
    ctx.scale = scale


def _backward(ctx, dout, _dlse):
    q, k, v, out, lse, mask = ctx.saved_tensors
    dq, dk, dv = attention_bwd_op(q, k, v, out, lse, dout.contiguous(), mask, ctx.scale)
    return dq, dk, dv, None, None, None


torch.library.register_autograd("sevit::attention_fwd", _backward,
                                setup_context=_setup_context, lib=kernels.LIBRARY)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over ``[B, H, N, D]`` tensors with an optional ``[B, N]``
    bool key mask, differentiable, through the op ``sevit::attention_fwd``
    (which writes the log-sum-exp only when a gradient is wanted). CPU:
    plain version; CUDA: kernel K2 (and its backward), which walks only the
    keys a masked row keeps. Its blocks list those keys in shared memory, 4
    bytes a key, so a mask over more than about 37,000 keys (head dim 64;
    fewer in the backward, whose A operands and tiles take more: 30,956;
    7,946 at 128) does not fit and raises. A head dim that is not an
    instance runs the next larger one (``kernel_head_dim``), under that
    instance's limits; above 128 the sliced instance, whose forward and
    backward hold about 38,500 keys, since its backward keeps no A operands
    in shared memory."""
    _check(q, k, v, mask)
    if kernels.uses_kernel(q):
        _check_kernel_inputs((("q", q), ("k", k), ("v", v)), q.shape[-1])
    with_lse = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return attention_fwd_op(q, k, v, mask, float(scale), with_lse)[0]


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


# ---------------------------------------------------------------------------
# K2r: Shaw's relative-position attention (CMGAN's conformers), forward only
# ---------------------------------------------------------------------------

RELPOS_HEAD_DIMS = (16,)  # csrc/attention_relpos.cu template instances


def relative_offsets(n: int, max_pos: int, device=None) -> torch.Tensor:
    """``[n, n]`` rows of the table that query i and key j read:
    ``clamp(i - j, -max_pos, max_pos) + max_pos``."""
    seq = torch.arange(n, device=device)
    return (seq[:, None] - seq[None, :]).clamp(-max_pos, max_pos) + max_pos


def attention_relpos_plain(q, k, v, emb, max_pos: int, *, scale: float, mask=None):
    """Plain version of K2r, the published einsums (the conformer's
    ``Attention`` of CMGAN's ``conformer.py``): ``q, k, v [G, H, N, D]``,
    ``emb [2 max_pos + 1, D]``, logits ``q_i.k_j * scale + q_i.E[clamp(i -
    j)] * scale``, masked keys (``mask [G, N]`` bool, True = attend) at
    -1e30, softmax, times v."""
    rel = F.embedding(relative_offsets(q.shape[-2], max_pos, q.device), emb)  # [N, N, D]
    dots = torch.einsum("bhid,bhjd->bhij", q, k) * scale
    dots = dots + torch.einsum("bhnd,nrd->bhnr", q, rel) * scale
    if mask is not None:
        dots = dots.masked_fill(~mask[:, None, None, :], NEG_INF)
    return torch.einsum("bhij,bhjd->bhid", dots.softmax(dim=-1), v)


def _check_relpos(q, k, v, emb, max_pos, mask):
    _check(q, k, v, mask)
    if emb.dim() != 2 or emb.shape != (2 * max_pos + 1, q.shape[-1]):
        raise ValueError(f"attention_relpos: emb must be [2 * {max_pos} + 1, {q.shape[-1]}], "
                         f"got {tuple(emb.shape)}")
    if emb.device != q.device:
        raise ValueError("attention_relpos: inputs on different devices")


def _relpos_kernel(q, k, v, emb, max_pos, mask, scale):
    """Launch K2r (the op's CUDA impl)."""
    g, h, n, d = q.shape
    named = (("q", q), ("k", k), ("v", v), ("emb", emb))
    for name, t in named:  # (a parameter's requires_grad: attention_relpos refuses a gradient)
        kernels.check_input(f"attention_relpos {name}", t, 4 if name != "emb" else 2,
                            differentiable=True)
    if d not in RELPOS_HEAD_DIMS:
        raise ValueError(f"attention_relpos kernel: head dim {d}, instances {RELPOS_HEAD_DIMS}")
    _check_aligned(named)
    if mask is not None:
        mask = mask.contiguous()
    out = torch.empty_like(q)
    if g * h and n:
        with torch.cuda.device(q.device):
            kernels.launch(
                "attention_relpos", q.data_ptr(), k.data_ptr(), v.data_ptr(), emb.data_ptr(),
                None if mask is None else mask.data_ptr(), out.data_ptr(),
                g * h, h, n, d, int(max_pos), float(scale) * LOG2E,
            )
    return out


def _relpos_plain_op(q, k, v, emb, max_pos, mask, scale):
    return attention_relpos_plain(q, k, v, emb, max_pos, scale=scale, mask=mask)


def _relpos_fake(q, k, v, emb, max_pos, mask, scale):
    return torch.empty_like(q)


attention_relpos_op = kernels.define_op(
    "attention_relpos_fwd",
    "(Tensor q, Tensor k, Tensor v, Tensor emb, int max_pos, Tensor? mask, float scale)"
    " -> Tensor",
    cpu=_relpos_plain_op, cuda=_relpos_kernel, fake=_relpos_fake)


def attention_relpos(q, k, v, emb, max_pos: int, *, scale: float, mask=None,
                     kept_keys: Optional[int] = None) -> torch.Tensor:
    """Relative-position attention over ``[G, H, N, D]`` tensors, forward
    only, through the op ``sevit::attention_relpos_fwd``: CPU, the plain
    version; CUDA, kernel K2r (head dim 16), which walks only the key tiles
    that hold a kept key and takes each offset from the keys' original
    positions. ``mask`` ``[G, N]`` bool (True = attend). Counts the call
    (``attention.relpos_calls``) and the query-key pairs over kept keys
    (``attention.relpos_pairs``): ``kept_keys``, the kept keys summed over
    the G rows, where the caller knows it on the host; without a mask every
    key; a CPU mask is summed; a CUDA mask without ``kept_keys`` is not read
    (that would wait for the device) and counts no pairs. Refuses a
    gradient: K2r has no backward."""
    from ..utils import tracing

    _check_relpos(q, k, v, emb, max_pos, mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, emb)):
        raise RuntimeError("attention_relpos: forward only (K2r has no backward); run under "
                           "torch.no_grad() or torch.inference_mode()")
    g, h, n, _ = q.shape
    if kept_keys is None and mask is None:
        kept_keys = g * n
    elif kept_keys is None and not kernels.uses_kernel(mask):
        kept_keys = int(mask.sum())
    tracing.count("attention.relpos_calls")
    if kept_keys is not None:
        tracing.count("attention.relpos_pairs", h * n * int(kept_keys))
    return attention_relpos_op(q, k, v, emb, int(max_pos), mask, float(scale))


def relpos_kernel_info(d: int, n: int, masked: bool = True) -> dict:
    """Registers and local (spill) bytes per thread, shared memory per
    block and resident blocks per SM of K2r's instance for head dim ``d`` at
    ``n`` keys, as the CUDA runtime reports them (needs the card)."""
    fn = kernels.library()["attention_relpos"].sevit_attention_relpos_info
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in range(4)]
    err = fn(d, n, int(masked), *(ctypes.byref(x) for x in vals))
    if err != 0:
        raise RuntimeError(f"sevit_attention_relpos_info failed with error {err}")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"),
                    (x.value for x in vals)))
