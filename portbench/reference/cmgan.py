"""The plain reference of CMGAN's generator and its enhancement pipeline:
plain PyTorch operations on a dict of weights, float32, no kernel of the
port and nothing the port made.

The architecture is the authors' ``TSCNet`` (github.com/ruizhecao96/CMGAN,
``src/models/generator.py`` and ``conformer.py``; arXiv:2203.15149): a
dilated DenseNet encoder at the full 201 bins, four two-stage conformer
blocks (time, then frequency; Shaw's relative-position attention, the
published einsums), a mask decoder and a complex decoder. The pipeline is the
authors' evaluation: each row scaled to unit RMS, ``torch.stft`` at 400/100
with a periodic Hamming window, power compression ``|X|^0.3``, the model,
decompression, ``torch.istft``, the scale undone. Departures, the
configuration's ``assumed.padding``: rows are padded together to a bucket
(the authors run one clip, wrapped to a multiple of the hop) and the padded
frames are masked: InstanceNorm statistics over the valid frames, the padded
keys of the time attention masked, the padded frames zeroed before each
depthwise convolution. Weights are named as the port's ``state_dict`` names
them (the authors' names). The control is ``hvit.lower_precision``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .pipeline import _pcm16_in

LN_EPS = 1e-5
IN_EPS = 1e-5
BN_EPS = 1e-5
NEG_INF = -1e30
HEADS = 4
MAX_POS = 512


def _prelu(x, w):
    return torch.where(x >= 0, x, w.view(1, -1, *([1] * (x.dim() - 2))) * x)


def _instance_norm(p, name, x, valid):
    """Affine InstanceNorm over ``[B, C, T, F]``, its statistics over the
    valid frames (``valid [B, 1, T, 1]``)."""
    count = valid.sum(dim=2, keepdim=True) * x.shape[-1]
    mean = (x * valid).sum(dim=(2, 3), keepdim=True) / count
    var = (((x - mean) ** 2) * valid).sum(dim=(2, 3), keepdim=True) / count
    y = (x - mean) / torch.sqrt(var + IN_EPS)
    return y * p[f"{name}.weight"].view(1, -1, 1, 1) + p[f"{name}.bias"].view(1, -1, 1, 1)


def _conv(p, name, x, **kw):
    return F.conv2d(x, p[f"{name}.weight"], p[f"{name}.bias"], **kw)


def dilated_dense(p, pre, x, valid):
    skip = x
    for i in range(1, 5):
        d = 2 ** (i - 1)
        out = _conv(p, f"{pre}.conv{i}", F.pad(skip, (1, 1, d, 0)), dilation=(d, 1))
        out = _prelu(_instance_norm(p, f"{pre}.norm{i}", out, valid), p[f"{pre}.prelu{i}.weight"])
        skip = torch.cat([out, skip], dim=1)
    return out


def _layer_norm(p, name, x):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], LN_EPS)


def _linear(p, name, x):
    return F.linear(x, p[f"{name}.weight"], p.get(f"{name}.bias"))


def _swish(x):
    return x * torch.sigmoid(x)


def _feed_forward(p, pre, x):
    h = _layer_norm(p, f"{pre}.fn.norm", x)
    h = _linear(p, f"{pre}.fn.fn.net.3", _swish(_linear(p, f"{pre}.fn.fn.net.0", h)))
    return 0.5 * h


def _attention(p, pre, x, mask):
    """The published einsums, logits ``[rows, heads, N, N]`` explicit."""
    h = _layer_norm(p, f"{pre}.norm", x)
    g, n, _ = h.shape
    q = _linear(p, f"{pre}.fn.to_q", h)
    k, v = _linear(p, f"{pre}.fn.to_kv", h).chunk(2, dim=-1)
    q, k, v = (t.reshape(g, n, HEADS, -1).transpose(1, 2) for t in (q, k, v))
    scale = q.shape[-1] ** -0.5
    dots = torch.einsum("bhid,bhjd->bhij", q, k) * scale
    seq = torch.arange(n, device=x.device)
    dist = (seq[:, None] - seq[None, :]).clamp(-MAX_POS, MAX_POS) + MAX_POS
    rel = p[f"{pre}.fn.rel_pos_emb.weight"][dist]
    dots = dots + torch.einsum("bhnd,nrd->bhnr", q, rel) * scale
    if mask is not None:
        dots = dots.masked_fill(~mask[:, None, None, :], NEG_INF)
    out = torch.einsum("bhij,bhjd->bhid", dots.softmax(dim=-1), v)
    return _linear(p, f"{pre}.fn.to_out", out.transpose(1, 2).reshape(g, n, -1))


def _conv_module(p, pre, x, mask):
    h = _layer_norm(p, f"{pre}.net.0", x).transpose(1, 2)
    h = F.glu(F.conv1d(h, p[f"{pre}.net.2.weight"], p[f"{pre}.net.2.bias"]), dim=1)
    if mask is not None:
        h = h * mask[:, None, :].to(h.dtype)
    w = p[f"{pre}.net.4.conv.weight"]
    pad = w.shape[-1] // 2
    h = F.conv1d(F.pad(h, (pad, pad)), w, p[f"{pre}.net.4.conv.bias"], groups=w.shape[0])
    bn = f"{pre}.net.5"
    h = (h - p[f"{bn}.running_mean"][None, :, None]) / torch.sqrt(
        p[f"{bn}.running_var"][None, :, None] + BN_EPS) * p[f"{bn}.weight"][None, :, None] \
        + p[f"{bn}.bias"][None, :, None]
    h = F.conv1d(_swish(h), p[f"{pre}.net.7.weight"], p[f"{pre}.net.7.bias"])
    return h.transpose(1, 2)


def conformer(p, pre, x, mask):
    x = _feed_forward(p, f"{pre}.ff1", x) + x
    x = _attention(p, f"{pre}.attn", x, mask) + x
    x = _conv_module(p, f"{pre}.conv", x, mask) + x
    x = _feed_forward(p, f"{pre}.ff2", x) + x
    return _layer_norm(p, f"{pre}.post_norm", x)


def tscb(p, pre, x, frames):
    b, c, t, f = x.shape
    x_t = x.permute(0, 3, 2, 1).reshape(b * f, t, c)
    mask = frames[:, None, :].expand(b, f, t).reshape(b * f, t)
    x_t = conformer(p, f"{pre}.time_conformer", x_t, mask) + x_t
    x_f = x_t.reshape(b, f, t, c).permute(0, 2, 1, 3).reshape(b * t, f, c)
    x_f = conformer(p, f"{pre}.freq_conformer", x_f, None) + x_f
    return x_f.reshape(b, t, f, c).permute(0, 3, 1, 2)


def _sub_pixel(p, name, x):
    out = _conv(p, f"{name}.conv", F.pad(x, (1, 1, 0, 0)))
    b, nch, h, w = out.shape
    return out.reshape(b, 2, nch // 2, h, w).permute(0, 2, 3, 4, 1).reshape(b, nch // 2, h, -1)


def forward(p: dict, x: torch.Tensor, n_valid: torch.Tensor):
    """``(Y_re, Y_im)`` ``[B, 1, T, F]`` of the compressed spectrum ``x
    [B, 2, T, F]`` with ``n_valid [B]`` valid frames a row."""
    t = x.shape[2]
    frames = torch.arange(t, device=x.device)[None, :] < n_valid[:, None]
    valid = frames[:, None, :, None].to(x.dtype)
    mag = torch.sqrt(x[:, 0] ** 2 + x[:, 1] ** 2).unsqueeze(1)
    phase = torch.angle(torch.complex(x[:, 0], x[:, 1])).unsqueeze(1)
    e = "dense_encoder"
    out = _prelu(_instance_norm(p, f"{e}.conv_1.1", _conv(p, f"{e}.conv_1.0",
                                                            torch.cat([mag, x], dim=1)), valid),
                 p[f"{e}.conv_1.2.weight"])
    out = dilated_dense(p, f"{e}.dilated_dense", out, valid)
    out = _prelu(_instance_norm(p, f"{e}.conv_2.1",
                                _conv(p, f"{e}.conv_2.0", out, stride=(1, 2), padding=(0, 1)),
                                valid), p[f"{e}.conv_2.2.weight"])
    for i in range(1, 5):
        out = tscb(p, f"TSCB_{i}", out, frames)
    m = "mask_decoder"
    h = _sub_pixel(p, f"{m}.sub_pixel", dilated_dense(p, f"{m}.dense_block", out, valid))
    h = _prelu(_instance_norm(p, f"{m}.norm", _conv(p, f"{m}.conv_1", h), valid),
               p[f"{m}.prelu.weight"])
    h = _conv(p, f"{m}.final_conv", h).permute(0, 3, 2, 1).squeeze(-1)  # [B, F, T]
    mask = _prelu(h, p[f"{m}.prelu_out.weight"]).permute(0, 2, 1).unsqueeze(1)
    c = "complex_decoder"
    h = _sub_pixel(p, f"{c}.sub_pixel", dilated_dense(p, f"{c}.dense_block", out, valid))
    h = _prelu(_instance_norm(p, f"{c}.norm", h, valid), p[f"{c}.prelu.weight"])
    comp = _conv(p, f"{c}.conv", h)
    out_mag = mask * mag
    return (out_mag * torch.cos(phase) + comp[:, 0:1],
            out_mag * torch.sin(phase) + comp[:, 1:2])


def _window(audio: dict, device) -> torch.Tensor:
    if audio["window"] != "hamming" or audio["win_length"] != audio["n_fft"]:
        raise ValueError(f"the reference takes CMGAN's full-length Hamming window, got {audio}")
    return torch.hamming_window(audio["n_fft"], device=device)


def block_rows(padded_len: int, hop: int) -> int:
    """Rows a block, so that the explicit time logits ``[rows * 101, 4, T,
    T]`` stay near two rows' at 1024 frames (3.4 GB)."""
    t = 1 + padded_len // hop
    return max(1, (2 * 1024 * 1024) // (t * t))


@torch.no_grad()
def enhance_rows(p: dict, config: dict, clips: list, padded_len: int, device) -> list:
    """Enhance PCM16 ``clips`` padded together to ``padded_len`` samples:
    RMS normalize over each clip's length, STFT, power compress, the model
    with the padded frames masked, decompress, iSTFT, PCM16 out. Returns
    each clip's float32 output (PCM16 / 32767) at its own length."""
    audio = config["audio"]
    n_fft, hop = int(audio["n_fft"]), int(audio["hop_length"])
    batch = np.zeros((len(clips), padded_len), np.int16)
    for row, c in enumerate(clips):
        batch[row, : len(c)] = _pcm16_in(c)
    x = torch.from_numpy(batch).to(device).to(torch.float32) / 32768.0
    lengths = torch.tensor([len(c) for c in clips], device=device)
    energy = torch.sum(x * x, dim=-1, keepdim=True)
    scale = torch.where(energy > 0, torch.sqrt(lengths[:, None].to(x.dtype) / energy),
                        torch.ones_like(energy))
    win = _window(audio, device)
    spec = torch.stft(x * scale, n_fft, hop, n_fft, window=win, center=True, pad_mode="reflect",
                      onesided=True, return_complex=True)
    mag, phase = spec.abs() ** 0.3, spec.angle()
    comp = torch.stack([mag * torch.cos(phase), mag * torch.sin(phase)], dim=1)  # [B, 2, F, T]
    y_re, y_im = forward(p, comp.permute(0, 1, 3, 2), 1 + lengths // hop)
    out = torch.complex(y_re[:, 0], y_im[:, 0]).transpose(1, 2)  # [B, F, T]
    out_mag, out_phase = out.abs() ** (1.0 / 0.3), out.angle()
    est = torch.complex(out_mag * torch.cos(out_phase), out_mag * torch.sin(out_phase))
    y = torch.istft(est, n_fft, hop, n_fft, window=win, center=True, length=padded_len) / scale
    y16 = (torch.clamp(y, -1.0, 1.0) * 32767.0).to(torch.int16).cpu().numpy()
    return [y16[row, : len(c)].astype(np.float32) / 32767.0 for row, c in enumerate(clips)]
