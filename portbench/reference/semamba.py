"""The plain reference of SEMamba's generator and its enhancement pipeline:
plain PyTorch operations on a dict of weights, float32, no kernel of the
port and nothing the port made.

The architecture is the authors' (github.com/RoyChao19477/SEMamba,
``models/generator.py``, ``mamba_block.py`` and MP-SENet's
``codec_module.py``; arXiv:2405.06573): a dilated DenseBlock encoder at the
full 201 bins, four TFMamba blocks (a bidirectional Mamba over time, then
one over frequency, each direction mamba_ssm's ``Block``, ``Mamba(RMSNorm(x))
+ x``, the published selective scan as a loop over the steps), a magnitude
mask decoder and a phase decoder. The backward direction is the authors':
the forward Block on the flipped sequence, flipped back. The pipeline is the
authors' inference: each row scaled to unit RMS, ``torch.stft`` at 400/100
with a periodic Hann window, MP-SENet's ``mag_pha_stft`` (the magnitude
``sqrt(re^2 + im^2 + 1e-9)^0.3``, the phase ``atan2(im + 1e-10, re +
1e-5)``), the model, the magnitude decompressed, ``torch.istft`` at the
model's phase, the scale undone.

Departures, the configuration's ``assumed.padding``: rows are padded
together to a bucket (the authors run one clip) and the padded frames are
masked: InstanceNorm statistics over the valid frames; the padded frames
zeroed at each DenseBlock's input and after each of its layers, and at each
TFMamba block's input; over time, the flip is of each row's valid prefix,
and a scan's output at the padded steps is 0 (its state, which no valid
step reads, runs on). And the spectrum's imaginary parts that are 0 in exact
arithmetic (bins 0 and 200 of every frame; every bin of the first frame,
which reflect padding makes even about its centre and the periodic Hann
window keeps so) are set to 0: the FFT leaves rounding there, whose sign
puts MP-SENet's phase input at +pi or -pi where the real part is negative,
and two FFTs round them differently. Weights are named as the port's
``state_dict`` names them (the authors' names). The control is
``hvit.lower_precision``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .pipeline import _pcm16_in

IN_EPS = 1e-5


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


def _norm_prelu(p, pre, x, valid):
    """``pre.1`` (InstanceNorm) then ``pre.2`` (PReLU) of ``x``."""
    return _prelu(_instance_norm(p, f"{pre}.1", x, valid), p[f"{pre}.2.weight"])


def dense_block(p, pre, x, valid):
    skip = x * valid
    for i in range(4):
        d = 2 ** i
        out = _conv(p, f"{pre}.dense_block.{i}.0", skip, dilation=(d, 1), padding=(d, 1))
        out = _norm_prelu(p, f"{pre}.dense_block.{i}", out, valid)
        skip = torch.cat([out * valid, skip], dim=1)
    return out


def selective_scan(u, delta, a, b, c, d, z, delta_bias, active):
    """mamba_ssm's ``selective_scan_ref`` with ``delta_softplus``: ``u``,
    ``delta``, ``z`` ``[G, D, L]``, ``b``, ``c`` ``[G, N, L]``, ``a [D, N]``;
    the output 0 where ``active [G, L]`` is False."""
    delta = F.softplus(delta + delta_bias[None, :, None])
    h = u.new_zeros(u.shape[0], u.shape[1], a.shape[1])
    ys = []
    for t in range(u.shape[2]):
        h = torch.exp(delta[:, :, t, None] * a) * h \
            + (delta[:, :, t] * u[:, :, t])[:, :, None] * b[:, None, :, t]
        ys.append((h * c[:, None, :, t]).sum(-1))
    y = (torch.stack(ys, dim=-1) + u * d[None, :, None]) * F.silu(z)
    return y if active is None else y * active[:, None, :].to(y.dtype)


def mamba(p, pre, h, cfg, active):
    """mamba_ssm's ``Mamba.forward`` (its reference path) on ``h [G, L,
    d_model]``."""
    n_state = int(cfg["d_state"])
    d_inner = p[f"{pre}.D"].shape[0]
    dt_rank = p[f"{pre}.dt_proj.weight"].shape[1]
    length = h.shape[1]
    xz = F.linear(h, p[f"{pre}.in_proj.weight"]).transpose(1, 2)  # [G, 2 d_inner, L]
    x, z = xz.chunk(2, dim=1)
    w = p[f"{pre}.conv1d.weight"]
    x = F.silu(F.conv1d(x, w, p[f"{pre}.conv1d.bias"], padding=w.shape[-1] - 1,
                        groups=d_inner)[..., :length])
    x_dbl = F.linear(x.transpose(1, 2), p[f"{pre}.x_proj.weight"])  # [G, L, dt_rank + 2N]
    dt, b, c = torch.split(x_dbl, [dt_rank, n_state, n_state], dim=-1)
    dt = F.linear(dt, p[f"{pre}.dt_proj.weight"]).transpose(1, 2)
    a = -torch.exp(p[f"{pre}.A_log"])
    y = selective_scan(x, dt, a, b.transpose(1, 2), c.transpose(1, 2), p[f"{pre}.D"], z,
                       p[f"{pre}.dt_proj.bias"], active)
    return F.linear(y.transpose(1, 2), p[f"{pre}.out_proj.weight"])


def block(p, pre, x, cfg, active):
    """mamba_ssm's ``Block``: ``mixer(RMSNorm(x)) + x``."""
    h = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + float(cfg["norm_epsilon"])) \
        * p[f"{pre}.norm.weight"]
    return mamba(p, f"{pre}.mixer", h, cfg, active) + x


def _flip_prefix(x, n_valid):
    """Each row's first ``n_valid`` steps in reverse order, the rest as
    they are."""
    length = x.shape[1]
    s = torch.arange(length, device=x.device)[None, :]
    idx = torch.where(s < n_valid[:, None], n_valid[:, None] - 1 - s, s)
    return torch.gather(x, 1, idx[:, :, None].expand_as(x))


def mamba_block(p, pre, x, cfg, n_valid):
    """The authors' bidirectional ``MambaBlock`` on ``x [G, L, C]``, each
    row's first ``n_valid`` steps valid (None: all)."""
    length = x.shape[1]
    if n_valid is None:
        n_valid = torch.full((x.shape[0],), length, device=x.device)
        active = None
    else:
        active = torch.arange(length, device=x.device)[None, :] < n_valid[:, None]
    fwd = block(p, f"{pre}.forward_blocks.0", x, cfg, active)
    bwd = _flip_prefix(block(p, f"{pre}.backward_blocks.0", _flip_prefix(x, n_valid), cfg,
                             active), n_valid)
    return torch.cat([fwd, bwd], dim=-1)


def _conv_transpose_1x1(p, name, y, x):
    """The authors' ``tlinear`` / ``flinear`` on ``y [G, L, 2C]`` (as
    ``[G, 2C, L]``), plus the residual ``x``."""
    out = F.conv_transpose1d(y.transpose(1, 2), p[f"{name}.weight"], p[f"{name}.bias"])
    return out.transpose(1, 2) + x


def tfmamba(p, pre, x, cfg, n_valid, valid):
    b, c, t, f = x.shape
    x_t = (x * valid).permute(0, 3, 2, 1).reshape(b * f, t, c)
    y = mamba_block(p, f"{pre}.time_mamba", x_t, cfg, n_valid.repeat_interleave(f))
    x_t = _conv_transpose_1x1(p, f"{pre}.tlinear", y, x_t)
    x_f = x_t.reshape(b, f, t, c).permute(0, 2, 1, 3).reshape(b * t, f, c)
    x_f = _conv_transpose_1x1(p, f"{pre}.flinear", mamba_block(p, f"{pre}.freq_mamba", x_f, cfg,
                                                               None), x_f)
    return x_f.reshape(b, t, f, c).permute(0, 3, 1, 2)


def forward(p: dict, cfg: dict, x: torch.Tensor, n_valid: torch.Tensor):
    """``(mag, pha)`` ``[B, 1, T, F]`` of ``x [B, 2, T, F]`` (the compressed
    magnitude and the phase) with ``n_valid [B]`` valid frames a row;
    ``cfg`` the configuration's ``model`` section."""
    t = x.shape[2]
    frames = torch.arange(t, device=x.device)[None, :] < n_valid[:, None]
    valid = frames[:, None, :, None].to(x.dtype)
    e = "dense_encoder"
    out = _norm_prelu(p, f"{e}.dense_conv_1", _conv(p, f"{e}.dense_conv_1.0", x), valid)
    out = dense_block(p, f"{e}.dense_block", out, valid)
    out = _norm_prelu(p, f"{e}.dense_conv_2", _conv(p, f"{e}.dense_conv_2.0", out, stride=(1, 2)),
                      valid)
    for i in range(int(cfg["num_tfmamba"])):
        out = tfmamba(p, f"TSMamba.{i}", out, cfg, n_valid, valid)
    m = "mask_decoder"
    h = dense_block(p, f"{m}.dense_block", out, valid)
    h = F.conv_transpose2d(h, p[f"{m}.mask_conv.0.weight"], p[f"{m}.mask_conv.0.bias"],
                           stride=(1, 2))
    h = _instance_norm(p, f"{m}.mask_conv.2", _conv(p, f"{m}.mask_conv.1", h), valid)
    h = _conv(p, f"{m}.mask_conv.4", _prelu(h, p[f"{m}.mask_conv.3.weight"]))
    h = h.permute(0, 3, 2, 1).squeeze(-1)  # [B, F, T]
    mask = (float(cfg["beta"]) * torch.sigmoid(p[f"{m}.lsigmoid.slope"] * h))
    mask = mask.permute(0, 2, 1).unsqueeze(1)
    ph = "phase_decoder"
    h = dense_block(p, f"{ph}.dense_block", out, valid)
    h = F.conv_transpose2d(h, p[f"{ph}.phase_conv.0.weight"], p[f"{ph}.phase_conv.0.bias"],
                           stride=(1, 2))
    h = _norm_prelu(p, f"{ph}.phase_conv", h, valid)
    pha = torch.atan2(_conv(p, f"{ph}.phase_conv_i", h), _conv(p, f"{ph}.phase_conv_r", h))
    return mask * x[:, 0:1], pha


def _window(audio: dict, device) -> torch.Tensor:
    if audio["window"] != "hann" or audio["win_length"] != audio["n_fft"]:
        raise ValueError(f"the reference takes SEMamba's full-length Hann window, got {audio}")
    return torch.hann_window(audio["n_fft"], device=device)


def block_rows(padded_len: int, hop: int) -> int:
    """Rows a block, so that the DenseBlocks' widest input (256 channels at
    201 bins) stays near ten rows' at 1638 frames (~11 GB)."""
    t = 1 + padded_len // hop
    return max(1, 16384 // t)


@torch.no_grad()
def enhance_rows(p: dict, config: dict, clips: list, padded_len: int, device) -> list:
    """Enhance PCM16 ``clips`` padded together to ``padded_len`` samples:
    RMS normalize over each clip's length, STFT, magnitude and phase, the
    model with the padded frames masked, decompress, iSTFT at the model's
    phase, PCM16 out. Returns each clip's float32 output (PCM16 / 32767) at
    its own length."""
    audio, cfg = config["audio"], config["model"]
    n_fft, hop = int(audio["n_fft"]), int(audio["hop_length"])
    cf = float(cfg["compress_factor"])
    batch = np.zeros((len(clips), padded_len), np.int16)
    for row, c in enumerate(clips):
        batch[row, : len(c)] = _pcm16_in(c)
    x = torch.from_numpy(batch).to(device).to(torch.float32) / 32768.0
    lengths = torch.tensor([len(c) for c in clips], device=device)
    energy = torch.sum(x * x, dim=-1, keepdim=True)
    scale = torch.where(energy > 0, torch.sqrt(lengths[:, None].to(x.dtype) / energy),
                        torch.ones_like(energy))
    win = _window(audio, device)
    spec = torch.view_as_real(torch.stft(x * scale, n_fft, hop, n_fft, window=win, center=True,
                                         pad_mode="reflect", onesided=True,
                                         return_complex=True))  # [B, F, T, 2]
    spec[:, 0, :, 1] = 0.0  # imaginary parts 0 in exact arithmetic (the docstring)
    spec[:, -1, :, 1] = 0.0
    spec[:, :, 0, 1] = 0.0
    mag = torch.sqrt(spec.pow(2).sum(-1) + 1e-9) ** cf
    pha = torch.atan2(spec[..., 1] + 1e-10, spec[..., 0] + 1e-5)
    out_mag, out_pha = forward(p, cfg, torch.stack([mag, pha], dim=1).permute(0, 1, 3, 2),
                               1 + lengths // hop)
    out_mag = out_mag[:, 0].transpose(1, 2) ** (1.0 / cf)
    out_pha = out_pha[:, 0].transpose(1, 2)
    est = torch.complex(out_mag * torch.cos(out_pha), out_mag * torch.sin(out_pha))
    y = torch.istft(est, n_fft, hop, n_fft, window=win, center=True, length=padded_len) / scale
    y16 = (torch.clamp(y, -1.0, 1.0) * 32767.0).to(torch.int16).cpu().numpy()
    return [y16[row, : len(c)].astype(np.float32) / 32767.0 for row, c in enumerate(clips)]
