"""The plain reference of the HybridViT, its STFT and the arithmetic around
them: plain PyTorch operations on a dict of weights, float32, no kernel of
the port and nothing the port made.

The architecture is the reference project's (CNN encoder with BatchNorm,
ReLU and max pools; conv patchify; pre-norm ViT with exact GELU; CNN decoder
with 1x1-projected U-Net skips resized bilinearly; here the sub-pixel
``fullres_mask`` head of the README's recipe with factored 2-D positions).
Weights are named as the benchmark draws them (``portbench/weights.py``).

``lower_precision()`` is the control: the same arithmetic in the next
precision below float32, TF32 for every matmul and convolution (on a CUDA
card cuBLAS's and cuDNN's own TF32; on the CPU, which has none, the operands
rounded to TF32's 10-bit mantissa).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LN_EPS = 1e-5
_TF32 = [False]


@contextlib.contextmanager
def lower_precision(on: bool = True):
    """Matmuls and convolutions in TF32 while the context is open."""
    cuda = torch.cuda.is_available()
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) if cuda \
        else None
    _TF32[0] = on
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        _TF32[0] = False
        if cuda:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _r(t: torch.Tensor) -> torch.Tensor:
    """An operand as TF32 holds it, where only emulation can give TF32 (the
    gradient passes as if unrounded)."""
    if not _TF32[0] or t.is_cuda:
        return t
    bits = t.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)  # round to nearest at bit 13
    return t + (r - t.detach()) if t.requires_grad else r


def conv(x, w, b=None, stride=1, padding=0):
    return F.conv2d(_r(x), _r(w), b, stride=stride, padding=padding)


def linear(x, w, b=None):
    return F.linear(_r(x), _r(w), b)


def matmul(a, b):
    return torch.matmul(_r(a), _r(b))


def batchnorm(x, p: dict, name: str, train: bool):
    g, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    return (x - mean[None, :, None, None]) / torch.sqrt(var[None, :, None, None] + BN_EPS) \
        * g[None, :, None, None] + b[None, :, None, None]


def layernorm(x, p: dict, name: str):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"], p[f"{name}.bias"], LN_EPS)


def bilinear(x, size):
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


def patch_grid(model_cfg: dict, f_bins: int, frames: int):
    """``(h, w, frames a patch column spans)`` after the pools and patchify."""
    down = int(model_cfg["transformer"]["patch_size"])
    f, t = f_bins, frames
    for pool in model_cfg["encoder"]["pool_sizes"]:
        if pool > 1:
            f, t, down = f // pool, t // pool, down * pool
    ps = int(model_cfg["transformer"]["patch_size"])
    return f // ps, t // ps, down


def key_mask(model_cfg: dict, f_bins: int, frames: int, hop: int, lengths) -> torch.Tensor:
    """``[B, h*w]`` True on the patches whose column overlaps a frame of
    real audio (``1 + ceil(length / hop)`` frames)."""
    h, w, down = patch_grid(model_cfg, f_bins, frames)
    rows = []
    for n in lengths.tolist():
        valid = 1 + math.ceil(max(int(n), 1) / hop)
        cols = torch.arange(w) * down < valid
        rows.append(cols[None, :].expand(h, w).reshape(-1))
    return torch.stack(rows).to(lengths.device)


def forward(p: dict, model_cfg: dict, x: torch.Tensor, mask=None, train: bool = False):
    """``[B, F, T, 1]`` normalized magnitudes -> ``[B, F, T, 1]`` in [-1, 1]."""
    enc, tr, dec = model_cfg["encoder"], model_cfg["transformer"], model_cfg["decoder"]
    in_f, in_t = x.shape[1], x.shape[2]
    x = x.permute(0, 3, 1, 2)
    x_in = x
    skips = []
    for i, (k, pool) in enumerate(zip(enc["kernel_sizes"], enc["pool_sizes"])):
        x = conv(x, p[f"encoder.{i}.conv.weight"], padding=k // 2)
        x = F.relu(batchnorm(x, p, f"encoder.{i}.bn", train))
        if pool > 1:
            x = F.max_pool2d(x, pool, pool)
        skips.append(x)

    ps = int(tr["patch_size"])
    x = conv(x, p["patch_embed.proj.weight"], p["patch_embed.proj.bias"], stride=ps)
    b, d, h, w = x.shape
    tokens = x.flatten(2).transpose(1, 2)
    pos = p["pos_encoding.pos_embed_freq"][:h, None, :] + p["pos_encoding.pos_embed_time"][None, :w, :]
    tokens = tokens + pos.reshape(1, h * w, d)

    heads = int(tr["num_heads"])
    dh = d // heads
    n = h * w
    for i in range(int(tr["num_layers"])):
        pre = f"transformer.blocks.{i}"
        y = layernorm(tokens, p, f"{pre}.norm1")
        qkv = linear(y, p[f"{pre}.attn.qkv.weight"], p[f"{pre}.attn.qkv.bias"])
        q, k, v = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
        s = matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
        if mask is not None:
            s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
        a = matmul(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(b, n, d)
        tokens = tokens + linear(a, p[f"{pre}.attn.proj.weight"], p[f"{pre}.attn.proj.bias"])
        y = layernorm(tokens, p, f"{pre}.norm2")
        y = F.gelu(linear(y, p[f"{pre}.mlp.fc1.weight"], p[f"{pre}.mlp.fc1.bias"]))
        tokens = tokens + linear(y, p[f"{pre}.mlp.fc2.weight"], p[f"{pre}.mlp.fc2.bias"])
    tokens = layernorm(tokens, p, "transformer.norm")
    feat = linear(tokens, p["to_feature_map.weight"], p["to_feature_map.bias"])
    x = feat.transpose(1, 2).reshape(b, -1, h, w)

    fullres = model_cfg.get("head", "resize") == "fullres_mask"
    rev = skips[::-1]
    chans = dec["channels"]
    for i, (k, up) in enumerate(zip(dec["kernel_sizes"], dec["upsample_factors"])):
        final = i == len(chans) - 1
        if final and fullres:
            break
        if dec.get("use_skip_connections", True) and not final and i < len(rev):
            skip = conv(rev[i], p[f"skip_proj.{i}.weight"], p[f"skip_proj.{i}.bias"])
            x = torch.cat([x, bilinear(skip, x.shape[-2:])], dim=1)
        if up > 1:
            x = x.repeat_interleave(up, dim=2).repeat_interleave(up, dim=3)
        x = conv(x, p[f"decoder.{i}.conv.weight"], padding=k // 2)
        if final:
            x = torch.tanh(x)
        else:
            x = F.relu(batchnorm(x, p, f"decoder.{i}.bn", train))

    if fullres:
        c = int(model_cfg.get("head_channels", 16))
        hs = conv(x, p["head_subpixel.weight"], p["head_subpixel.bias"], padding=1)
        bb, _, f0, t0 = hs.shape
        r = hs.shape[1] // c
        fu = tu = int(math.isqrt(r))
        # depth to space, channel (a * tu + b) * C + c to pixel (a, b)
        hs = hs.reshape(bb, fu, tu, c, f0, t0).permute(0, 3, 4, 1, 5, 2)
        hs = bilinear(hs.reshape(bb, c, f0 * fu, t0 * tu), (in_f, in_t))
        hs = F.relu(conv(torch.cat([hs, x_in], 1), p["head_refine.weight"],
                         p["head_refine.bias"], padding=1))
        x = torch.tanh(conv(hs, p["head_out.weight"], p["head_out.bias"], padding=1))
    else:
        x = bilinear(x, (in_f, in_t))
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# STFT: librosa's semantics through torch.stft / torch.istft
# ---------------------------------------------------------------------------


def _window(audio: dict, device) -> torch.Tensor:
    if audio.get("window", "hann") != "hann":
        raise ValueError("the reference knows the Hann window only")
    win = torch.hann_window(int(audio["win_length"]), periodic=True, dtype=torch.float64)
    pad = int(audio["n_fft"]) - int(audio["win_length"])
    return F.pad(win, (pad // 2, pad - pad // 2)).to(torch.float32).to(device)


def stft(x: torch.Tensor, audio: dict):
    """``x [B, L]`` -> ``(spectrum, magnitude)`` ``[B, F, T]``, centred with
    reflection padding."""
    spec = torch.stft(x, int(audio["n_fft"]), int(audio["hop_length"]),
                      window=_window(audio, x.device), center=True, pad_mode="reflect",
                      return_complex=True)
    return spec, spec.abs()


def istft(mag: torch.Tensor, phase: torch.Tensor, audio: dict, length: int) -> torch.Tensor:
    """Magnitude and phase ``[B, F, T]`` -> ``[B, length]``, window-sum
    normalized overlap-add, centre crop."""
    return torch.istft(torch.polar(mag, phase), int(audio["n_fft"]), int(audio["hop_length"]),
                       window=_window(audio, mag.device), center=True, length=length)


def frames_for(n_samples: int, hop: int) -> int:
    """Frames whose waveform ``(frames - 1) * hop`` covers ``n_samples``."""
    return 1 + -(-max(n_samples, 1) // hop)


def bucket_len(n_samples: int, buckets, hop: int) -> int:
    """Samples of the smallest bucket that holds ``n_samples``."""
    need = frames_for(n_samples, hop)
    frames = next((b for b in buckets if need <= b), buckets[-1])
    return (frames - 1) * hop
