"""A masked InstanceNorm, its affine step and the PReLU after it as one
hand-written kernel: the 16 such sites of CMGAN's generator, CUDA kernel
``instance_norm`` (``csrc/instance_norm.cu``), beside its plain PyTorch
version.

``instance_norm_prelu`` computes ``y = PReLU((x - mean) * rsqrt(var + eps)
* weight + bias; slope)`` over ``x [B, C, T, F]``, the mean and the biased
variance of each ``(b, c)`` plane taken over its first ``n_valid[b]``
frames (all ``T`` where ``n_valid`` is None) and every frame normalised by
them, forward only, through the op ``torch.ops.sevit.instance_norm_prelu``.
On a CPU tensor the op runs the plain version: the ATen calls the model
made for it unfused (the masked sums, ``nn.InstanceNorm2d`` where every
frame is valid, ``F.prelu``), so a CPU forward equals the unfused one bit
for bit. On a CUDA tensor it launches the kernels: the statistics over the
valid frames, their merge, then the normalisation and the PReLU, within fp32
rounding of the plain version. ``x`` is contiguous, or channels-last (the
decoders' DenseNets: cuDNN keeps the layout of the last conformer block's
permuted output) with C a power of two from 4 to 256; the output has x's
layout.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import kernels

CHUNK = 16384  # floats a block takes at most
MIN_CHUNK = 2048  # floats a block takes at least where planes are few
# blocks of 256 threads the plan gives each SM at least, where it can: on an
# H100 the one-channel [32, 1, 819, 201] ran at 76-77% of its bytes bound with
# 4, 68% with 8 and 67% with 16 (more, shorter blocks); [32, 64, 819, 201] at
# 87% with each
BLOCKS_PER_SM = 4
CHANNELS_LAST = (4, 8, 16, 32, 64, 128, 256)  # the channels a channels-last x may have


def instance_norm_prelu_plain(x, n_valid, weight, bias, slope, eps: float):
    """Plain version, in the order the unfused model rounds it: with
    ``n_valid`` the valid frames' float mask ``[B, 1, T, 1]``, the masked
    mean and biased variance, ``(x - mean) * rsqrt(var + eps) * weight +
    bias``; without, ``F.instance_norm``; then ``F.prelu``."""
    if n_valid is None:
        y = F.instance_norm(x, weight=weight, bias=bias, eps=eps)
    else:
        t = x.shape[2]
        frames = torch.arange(t, device=x.device)[None, :] < n_valid.to(x.device)[:, None]
        valid = frames[:, None, :, None].to(x.dtype)
        count = valid.sum(dim=2, keepdim=True) * x.shape[-1]
        mean = (x * valid).sum(dim=(2, 3), keepdim=True) / count
        var = (((x - mean) ** 2) * valid).sum(dim=(2, 3), keepdim=True) / count
        y = (x - mean) * torch.rsqrt(var + eps)
        y = y * weight[None, :, None, None] + bias[None, :, None, None]
    return F.prelu(y, slope)


def chunks_per_plane(planes: int, plane_len: int, sms: int) -> int:
    """The kernel's chunks a plane of ``plane_len`` floats (a row of ``T x F
    x C`` for a channels-last ``x``): at most ``CHUNK`` floats each, and,
    where that leaves fewer than ``BLOCKS_PER_SM`` blocks an SM, more of
    them, down to ``MIN_CHUNK`` floats each."""
    need = -(-plane_len // CHUNK)
    spread = -(-BLOCKS_PER_SM * sms // max(planes, 1))
    most = -(-plane_len // MIN_CHUNK)
    return max(1, need, min(spread, most))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x, n_valid, weight, bias, slope):
    if x.dim() != 4:
        raise ValueError(f"instance_norm_prelu: x must be [B, C, T, F], got {tuple(x.shape)}")
    b, c = x.shape[:2]
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"instance_norm_prelu: weight and bias must be [{c}]")
    if slope.dim() != 1 or slope.shape[0] not in (1, c):
        raise ValueError(f"instance_norm_prelu: slope must be [1] or [{c}], got "
                         f"{tuple(slope.shape)}")
    if n_valid is not None and (n_valid.shape != (b,) or n_valid.dtype != torch.int32):
        raise ValueError(f"instance_norm_prelu: n_valid must be int32 [{b}], got "
                         f"{n_valid.dtype} {tuple(n_valid.shape)}")
    if any(t is not None and t.device != x.device for t in (n_valid, weight, bias, slope)):
        raise ValueError("instance_norm_prelu: inputs on different devices")


def _kernel(x, n_valid, weight, bias, slope, eps):
    """Launch the kernels (the op's CUDA impl)."""
    _check(x, n_valid, weight, bias, slope)
    b, c, t, f = x.shape
    channels_last = not x.is_contiguous()
    if channels_last and not (x.is_contiguous(memory_format=torch.channels_last)
                              and c in CHANNELS_LAST):
        raise ValueError(f"instance_norm_prelu kernel: x must be contiguous, or channels-last "
                         f"with C in {CHANNELS_LAST}; got strides {x.stride()}")
    if x.dtype != torch.float32:
        raise TypeError(f"instance_norm_prelu x: expected float32, got {x.dtype}")
    for name, ten in (("weight", weight), ("bias", bias), ("slope", slope)):
        # a parameter's requires_grad: the wrapper refuses a gradient
        kernels.check_input(f"instance_norm_prelu {name}", ten, 1, differentiable=True)
    if x.data_ptr() % 16:
        raise ValueError("instance_norm_prelu kernel: x is not 16-byte aligned")
    if n_valid is not None and not n_valid.is_contiguous():
        raise ValueError("instance_norm_prelu kernel: n_valid must be contiguous")
    out = torch.empty_like(x)  # x's layout
    if x.numel():
        planes, plane_len = (b, t * f * c) if channels_last else (b * c, t * f)
        chunks = chunks_per_plane(planes, plane_len, _sms(x.device.index))
        scratch = x.new_empty(b * c * (4 * chunks + 2))  # partial moments, then mean and scale
        with torch.cuda.device(x.device):
            kernels.launch(
                "instance_norm", x.data_ptr(), None if n_valid is None else n_valid.data_ptr(),
                weight.data_ptr(), bias.data_ptr(), slope.data_ptr(), scratch.data_ptr(),
                out.data_ptr(), b, c, t, f, slope.shape[0], chunks, int(channels_last),
                float(eps),
            )
    return out


def _plain_op(x, n_valid, weight, bias, slope, eps):
    _check(x, n_valid, weight, bias, slope)
    return instance_norm_prelu_plain(x, n_valid, weight, bias, slope, eps)


def _fake(x, n_valid, weight, bias, slope, eps):
    return torch.empty_like(x)


instance_norm_prelu_op = kernels.define_op(
    "instance_norm_prelu",
    "(Tensor x, Tensor? n_valid, Tensor weight, Tensor bias, Tensor slope, float eps) -> Tensor",
    cpu=_plain_op, cuda=_kernel, fake=_fake)


def instance_norm_prelu(x: torch.Tensor, n_valid: Optional[torch.Tensor], weight: torch.Tensor,
                        bias: torch.Tensor, slope: torch.Tensor, eps: float) -> torch.Tensor:
    """``PReLU(InstanceNorm(x; weight, bias, eps); slope)`` over ``x [B, C,
    T, F]``, each plane's statistics over its first ``n_valid[b]`` frames
    (int32 ``[B]`` on x's device; None: all ``T``); ``slope`` ``[1]`` or
    ``[C]``. Forward only: refuses a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias, slope)):
        raise RuntimeError("instance_norm_prelu: forward only (the kernel has no backward); run "
                           "under torch.no_grad() or torch.inference_mode()")
    return instance_norm_prelu_op(x, n_valid, weight, bias, slope, float(eps))
