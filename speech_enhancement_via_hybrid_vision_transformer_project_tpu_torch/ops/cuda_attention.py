"""Scaled dot-product attention of the ViT blocks: CUDA kernel K2 (forward)
beside its plain PyTorch version.

``attention`` replaces the JAX package's ``fused_attention``
(``ops/pallas_attention.py``). A CPU tensor runs the plain version, a CUDA
tensor launches the kernel (``csrc/attention.cu``: a flash-attention
forward on the tensor cores in 3xTF32) or raises. The kernel has no
backward yet, so the wrapper refuses CUDA inputs that require grad.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import kernels

_HEAD_DIMS = (16, 32, 64, 128)  # csrc/attention.cu template instances
NEG_INF = -1e30  # masked-key logit, as sdpa_reference
LOG2E = 1.0 / math.log(2.0)  # the kernel's softmax runs in base 2


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
    by -1e30 (``mask``: ``[B, N]`` bool, True = attend)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w.to(q.dtype), v).to(q.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over ``[B, H, N, D]`` tensors with an optional ``[B, N]``
    bool key mask. CPU: plain version; CUDA: kernel K2, which walks only
    the keys a masked row keeps. Its blocks list those keys in shared
    memory, 4 bytes a key, so a mask over more than about 37,000 keys
    (head dim 64) does not fit and raises."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"attention: expected q, k, v [B, H, N, D] of one shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, n, d = q.shape
    if mask is not None and (mask.dtype != torch.bool or mask.shape != (b, n)):
        raise ValueError(f"attention: mask must be bool [B, N], got {mask.dtype} {tuple(mask.shape)}")
    tensors = (q, k, v) if mask is None else (q, k, v, mask)
    if any(t.device != q.device for t in tensors):
        raise ValueError("attention: inputs on different devices")
    if not kernels.uses_kernel(q):
        return attention_plain(q, k, v, scale=scale, mask=mask)
    for name, t in (("q", q), ("k", k), ("v", v)):
        kernels.check_input(f"attention {name}", t, 4)
        if t.data_ptr() % 16:  # float4 loads
            raise ValueError(f"attention {name}: expected a 16-byte aligned tensor")
    if d not in _HEAD_DIMS:
        raise ValueError(f"attention kernel: head dim {d} not in {_HEAD_DIMS}")
    if mask is not None:
        mask = mask.contiguous()
    out = torch.empty_like(q)
    if b * h and n:
        with torch.cuda.device(q.device):
            kernels.launch(
                "attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if mask is None else mask.data_ptr(), out.data_ptr(),
                b * h, h, n, d, float(scale) * LOG2E,
            )
    return out


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
