"""SEMamba's generator (Chao et al., "An Investigation of Incorporating
Mamba for Speech Enhancement", IEEE SLT 2024, arXiv:2405.06573; the
authors' ``models/generator.py``, ``mamba_block.py`` and MP-SENet's
``codec_module.py``, recipe ``SEMamba_advanced.yaml``), for inference on the
port's enhancer.

Layout ``[B, C, T, F]`` as the authors': ``x [B, 2, T, 201]`` is the
compressed magnitude ``|X|^0.3`` and the phase of the STFT (400/100 Hann);
the output is ``(mag, pha)``, each ``[B, 1, T, 201]``: the mask decoder's
mask times the input magnitude, and the phase decoder's phase. Modules are
named as the authors name them, so that their checkpoint's ``state_dict``
loads as it is: ``dense_encoder`` (``dense_conv_1``,
``dense_block.dense_block.{i}``, ``dense_conv_2``), ``TSMamba.{i}``
(``time_mamba``, ``freq_mamba``: ``forward_blocks.0`` and
``backward_blocks.0``, each mamba_ssm's ``Block``: ``norm``, an RMSNorm,
and ``mixer``, a Mamba-1 layer; ``tlinear``, ``flinear``),
``mask_decoder`` (``dense_block``, ``mask_conv``, ``lsigmoid.slope``),
``phase_decoder`` (``dense_block``, ``phase_conv``, ``phase_conv_r``,
``phase_conv_i``).

A TFMamba block runs a bidirectional Mamba over time for each frequency bin,
then one over frequency for each frame, each residual through a 1x1
transposed conv (``tlinear``, ``flinear``). Each direction is one Block,
``Mamba(RMSNorm(x)) + x``. The backward direction runs in place, in the
original order: its depthwise conv is the mirrored one (padded on the
right, the kernel flipped) and its scan runs from the last valid step down
(``ops.cuda_scan.selective_scan`` with ``reverse``), which is the authors'
forward Block on the flipped sequence, flipped back, with no copies.

Length masking, which the authors do not have (they run one clip at a
time): ``n_valid [B]`` frames of each row are real and the rest bucket
padding. Every InstanceNorm takes its statistics over the valid frames; the
padded frames are zeroed at each DenseBlock's input and after each of its
layers but the last, so its (3, 3) convolutions, non-causal in time, see
zeros there, and at each TFMamba block's input; the time scans run over each
row's valid frames (forward from its first, backward from its last, each
from a zero state) and the frequency scans over the valid frames only. Since
the RMSNorm and the projections before the depthwise conv have no bias, the
mirrored conv then sees exact zeros past a row's end, so a clip's output
does not depend on the bucket it is padded to.

The InstanceNorms with the PReLU after them (16 a forward) are one call of
``ops.cuda_instance_norm.instance_norm_prelu`` each (kernel
``instance_norm`` on CUDA), the Mamba layers' depthwise convs with their
SiLUs (16 a forward) one call of ``conv1d_silu`` each (kernel
``conv1d_silu``, reading x in place in the in_proj output) and the scans (16
a forward) one call of ``selective_scan`` each (kernel ``selective_scan``;
on the CPU their plain versions), all forward only: the model refuses
training mode.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda_instance_norm import instance_norm_prelu
from ..ops.cuda_scan import conv1d_silu, selective_scan
from ..utils import tracing


DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 1e-1, 1e-4  # Mamba's initial step range and floor


def _norm_prelu(x: torch.Tensor, norm: nn.InstanceNorm2d, prelu: nn.PReLU,
                n_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """``prelu(norm(x))`` over ``[B, C, T, F]``, the statistics over each
    row's first ``n_valid[b]`` frames (None: all): one
    ``instance_norm_prelu`` call; counts ``semamba.instance_norm_calls``."""
    tracing.count("semamba.instance_norm_calls")
    return instance_norm_prelu(x, n_valid, norm.weight, norm.bias, prelu.weight, norm.eps)


def _keep(x: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
    return x if keep is None else x * keep


class DenseBlock(nn.Module):
    """MP-SENet's dilated DenseNet: layer i a (3, 3) conv of ``hid * (i +
    1)`` channels to ``hid``, dilated ``2^i`` in time (padded on both sides),
    an affine InstanceNorm and a PReLU, its output put in front of the
    skip."""

    def __init__(self, hid_feature: int = 64, depth: int = 4):
        super().__init__()
        self.depth = depth
        self.dense_block = nn.ModuleList(
            nn.Sequential(
                nn.Conv2d(hid_feature * (i + 1), hid_feature, (3, 3), dilation=(2 ** i, 1),
                          padding=(2 ** i, 1)),
                nn.InstanceNorm2d(hid_feature, affine=True),
                nn.PReLU(hid_feature),
            )
            for i in range(depth)
        )

    def forward(self, x, n_valid=None, keep=None):
        """``keep [B, 1, T, 1]`` float, 1 at the valid frames (None: all)."""
        skip = _keep(x, keep)
        for i, layer in enumerate(self.dense_block):
            out = _norm_prelu(layer[0](skip), layer[1], layer[2], n_valid)
            if i + 1 < self.depth:
                skip = torch.cat([_keep(out, keep), skip], dim=1)
        return out


class DenseEncoder(nn.Module):
    def __init__(self, hid_feature: int = 64):
        super().__init__()
        self.dense_conv_1 = nn.Sequential(
            nn.Conv2d(2, hid_feature, (1, 1)),  # magnitude and phase in
            nn.InstanceNorm2d(hid_feature, affine=True),
            nn.PReLU(hid_feature),
        )
        self.dense_block = DenseBlock(hid_feature, depth=4)
        self.dense_conv_2 = nn.Sequential(
            nn.Conv2d(hid_feature, hid_feature, (1, 3), stride=(1, 2)),
            nn.InstanceNorm2d(hid_feature, affine=True),
            nn.PReLU(hid_feature),
        )

    def forward(self, x, n_valid=None, keep=None):
        c1, c2 = self.dense_conv_1, self.dense_conv_2
        x = _norm_prelu(c1[0](x), c1[1], c1[2], n_valid)
        x = self.dense_block(x, n_valid, keep)
        return _norm_prelu(c2[0](x), c2[1], c2[2], n_valid)  # F bins -> (F - 1) // 2


class RMSNorm(nn.Module):
    """mamba_ssm's ``RMSNorm``: ``x * rsqrt(mean(x^2) + eps) * weight``, no
    bias."""

    def __init__(self, hidden_size: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden_size))

    def forward(self, x):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * self.weight


class Mamba(nn.Module):
    """mamba_ssm's ``Mamba`` (Mamba-1) layer, with its published
    initialisation of ``A_log`` (``log(1 .. d_state)`` a channel), ``D``
    (ones) and ``dt_proj`` (Delta's bias the inverse softplus of a
    log-uniform step in [1e-3, 1e-1])."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4, expand: int = 2):
        super().__init__()
        self.d_inner = expand * d_model
        self.d_state = d_state
        self.dt_rank = math.ceil(d_model / 16)
        self.in_proj = nn.Linear(d_model, self.d_inner * 2, bias=False)
        self.conv1d = nn.Conv1d(self.d_inner, self.d_inner, d_conv, groups=self.d_inner,
                                padding=d_conv - 1)
        self.x_proj = nn.Linear(self.d_inner, self.dt_rank + 2 * d_state, bias=False)
        self.dt_proj = nn.Linear(self.dt_rank, self.d_inner, bias=True)
        std = self.dt_rank ** -0.5
        nn.init.uniform_(self.dt_proj.weight, -std, std)
        dt = torch.exp(torch.rand(self.d_inner) * (math.log(DT_MAX) - math.log(DT_MIN))
                       + math.log(DT_MIN)).clamp(min=DT_FLOOR)
        with torch.no_grad():
            self.dt_proj.bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        a = torch.arange(1, d_state + 1, dtype=torch.float32).repeat(self.d_inner, 1)
        self.A_log = nn.Parameter(torch.log(a))
        self.D = nn.Parameter(torch.ones(self.d_inner))
        self.out_proj = nn.Linear(self.d_inner, d_model, bias=False)

    def forward(self, h, n_valid=None, reverse: bool = False):
        """``y [G, L, d_inner]`` of the normalised ``h [G, L, d_model]``,
        before ``out_proj``; ``n_valid`` int32 ``[G]`` or None; ``reverse``:
        the scan and the conv run from each sequence's end."""
        xz = F.linear(h, self.in_proj.weight)
        x, z = xz.split(self.d_inner, dim=-1)
        tracing.count("semamba.conv_calls")
        u = conv1d_silu(x, self.conv1d.weight, self.conv1d.bias, reverse)
        x_dbl = F.linear(u, self.x_proj.weight)
        dt, b, c = x_dbl.split([self.dt_rank, self.d_state, self.d_state], dim=-1)
        delta = F.linear(dt, self.dt_proj.weight)  # its bias is added in the scan
        tracing.count("semamba.scan_calls")
        return selective_scan(u, delta, z, b, c, self.A_log, self.D, self.dt_proj.bias, n_valid,
                              reverse)


class Block(nn.Module):
    """mamba_ssm's ``Block`` with ``n_layer`` 1 and no fused add:
    ``mixer(norm(x)) + x``."""

    def __init__(self, d_model: int, d_state: int, d_conv: int, expand: int, eps: float):
        super().__init__()
        self.mixer = Mamba(d_model, d_state, d_conv, expand)
        self.norm = RMSNorm(d_model, eps)

    def forward(self, x, n_valid=None, reverse: bool = False, tokens: Optional[int] = None):
        """``tokens``: the steps the scan runs, where the host knows them
        (``semamba.scan_tokens``)."""
        if tokens is not None:
            tracing.count("semamba.scan_tokens", tokens)
        y = self.mixer(self.norm(x), n_valid, reverse)
        g, n, c = x.shape
        return torch.addmm(x.reshape(g * n, c), y.reshape(g * n, -1),
                           self.mixer.out_proj.weight.t()).view(g, n, c)


class MambaBlock(nn.Module):
    """The authors' bidirectional ``MambaBlock``: a forward and a backward
    Block on ``[G, L, C]``, their outputs side by side ``[G, L, 2C]``."""

    def __init__(self, in_channels: int, d_state: int, d_conv: int, expand: int, eps: float):
        super().__init__()
        self.forward_blocks = nn.ModuleList([Block(in_channels, d_state, d_conv, expand, eps)])
        self.backward_blocks = nn.ModuleList([Block(in_channels, d_state, d_conv, expand, eps)])

    def forward(self, x, n_valid=None, tokens: Optional[int] = None):
        return torch.cat([self.forward_blocks[0](x, n_valid, False, tokens),
                          self.backward_blocks[0](x, n_valid, True, tokens)], dim=-1)


def _linear_1x1(conv: nn.ConvTranspose1d, y, x):
    """``conv`` (a kernel-1 ``ConvTranspose1d`` over the channels of ``y
    [G, L, 2C]``) as a linear layer, plus the residual ``x``."""
    return F.linear(y, conv.weight[:, :, 0].t(), conv.bias) + x


class TFMambaBlock(nn.Module):
    def __init__(self, hid_feature: int = 64, d_state: int = 16, d_conv: int = 4,
                 expand: int = 4, norm_epsilon: float = 1e-5):
        super().__init__()
        kw = dict(d_state=d_state, d_conv=d_conv, expand=expand, eps=norm_epsilon)
        self.time_mamba = MambaBlock(hid_feature, **kw)
        self.freq_mamba = MambaBlock(hid_feature, **kw)
        self.tlinear = nn.ConvTranspose1d(hid_feature * 2, hid_feature, 1, stride=1)
        self.flinear = nn.ConvTranspose1d(hid_feature * 2, hid_feature, 1, stride=1)

    def forward(self, x, keep=None, n_time=None, n_freq=None, tokens: Optional[int] = None):
        """``x [B, C, T, F]``; ``keep [B, 1, T, 1]`` (zeroes the padded
        frames of the input), ``n_time [B * F]`` and ``n_freq [B * T]`` the
        scans' valid steps (None: all); ``tokens`` the valid (frame, bin)
        pairs, where the host knows them."""
        b, c, t, f = x.shape
        x_t = x.permute(0, 3, 2, 1)
        if keep is None:
            x_t = x_t.contiguous()
        else:  # the padded frames zeroed in the same pass as the permute
            x_t = torch.mul(x_t, keep.permute(0, 3, 2, 1),
                            out=torch.empty(b, f, t, c, device=x.device, dtype=x.dtype))
        x_t = x_t.view(b * f, t, c)
        x_t = _linear_1x1(self.tlinear, self.time_mamba(x_t, n_time, tokens), x_t)
        x_f = x_t.view(b, f, t, c).permute(0, 2, 1, 3).contiguous().view(b * t, f, c)
        x_f = _linear_1x1(self.flinear, self.freq_mamba(x_f, n_freq, tokens), x_f)
        return x_f.view(b, t, f, c).permute(0, 3, 1, 2)


class LearnableSigmoid2D(nn.Module):
    """MP-SENet's ``LearnableSigmoid2d``: ``beta * sigmoid(slope_f * x)``,
    ``slope [F, 1]``, here over ``x [B, 1, T, F]``."""

    def __init__(self, in_features: int, beta: float = 1.0):
        super().__init__()
        self.beta = beta
        self.slope = nn.Parameter(torch.ones(in_features, 1))

    def forward(self, x):
        return self.beta * torch.sigmoid(self.slope[:, 0] * x)


class MagDecoder(nn.Module):
    def __init__(self, hid_feature: int = 64, n_fft: int = 400, beta: float = 2.0):
        super().__init__()
        self.dense_block = DenseBlock(hid_feature, depth=4)
        self.mask_conv = nn.Sequential(
            nn.ConvTranspose2d(hid_feature, hid_feature, (1, 3), (1, 2)),
            nn.Conv2d(hid_feature, 1, (1, 1)),
            nn.InstanceNorm2d(1, affine=True),
            nn.PReLU(1),
            nn.Conv2d(1, 1, (1, 1)),
        )
        self.lsigmoid = LearnableSigmoid2D(n_fft // 2 + 1, beta=beta)

    def forward(self, x, n_valid=None, keep=None):
        m = self.mask_conv
        x = m[1](m[0](self.dense_block(x, n_valid, keep)))
        return self.lsigmoid(m[4](_norm_prelu(x, m[2], m[3], n_valid)))


class PhaseDecoder(nn.Module):
    def __init__(self, hid_feature: int = 64):
        super().__init__()
        self.dense_block = DenseBlock(hid_feature, depth=4)
        self.phase_conv = nn.Sequential(
            nn.ConvTranspose2d(hid_feature, hid_feature, (1, 3), (1, 2)),
            nn.InstanceNorm2d(hid_feature, affine=True),
            nn.PReLU(hid_feature),
        )
        self.phase_conv_r = nn.Conv2d(hid_feature, 1, (1, 1))
        self.phase_conv_i = nn.Conv2d(hid_feature, 1, (1, 1))

    def forward(self, x, n_valid=None, keep=None):
        p = self.phase_conv
        x = _norm_prelu(p[0](self.dense_block(x, n_valid, keep)), p[1], p[2], n_valid)
        return torch.atan2(self.phase_conv_i(x), self.phase_conv_r(x))


class SEMamba(nn.Module):
    """SEMamba's generator: ``forward(x, n_valid=None, kept_frames=None)``.

    ``x [B, 2, T, F]`` the compressed magnitude and the phase; ``n_valid
    [B]`` (int, on x's device) the valid frames of each row, or None for
    all; ``kept_frames``, the host's sum of ``n_valid``, feeds the counters
    (``semamba.true_frames``, ``semamba.padded_frames``,
    ``semamba.scan_tokens``) without reading the device. Returns ``(mag,
    pha)``."""

    def __init__(self, hid_feature: int = 64, num_tfmamba: int = 4, d_state: int = 16,
                 d_conv: int = 4, expand: int = 4, norm_epsilon: float = 1e-5,
                 n_fft: int = 400, beta: float = 2.0, compress_factor: float = 0.3):
        super().__init__()
        self.compress_factor = compress_factor  # of the magnitude, in and out (the enhancer's)
        self.dense_encoder = DenseEncoder(hid_feature)
        self.TSMamba = nn.ModuleList(
            TFMambaBlock(hid_feature, d_state, d_conv, expand, norm_epsilon)
            for _ in range(num_tfmamba))
        self.mask_decoder = MagDecoder(hid_feature, n_fft, beta)
        self.phase_decoder = PhaseDecoder(hid_feature)

    def forward(self, x, n_valid=None, kept_frames=None):
        if self.training:
            raise RuntimeError("SEMamba runs for inference only (eval mode): its scan kernel "
                               "has no backward")
        b, _, t, f = x.shape
        f_in = (f - 3) // 2 + 1  # dense_conv_2's bins
        keep = n_time = n_freq = None
        valid_frames = b * t
        if n_valid is not None:
            n_valid = n_valid.to(device=x.device, dtype=torch.int32)
            frames = torch.arange(t, device=x.device)[None, :] < n_valid[:, None]
            keep = frames[:, None, :, None].to(x.dtype)
            n_time = n_valid.repeat_interleave(f_in)
            n_freq = (frames.to(torch.int32) * f_in).view(-1)
            valid_frames = None if kept_frames is None else int(kept_frames)
        if kept_frames is not None:
            tracing.count("semamba.true_frames", int(kept_frames))
            tracing.count("semamba.padded_frames", b * t)
        tokens = None if valid_frames is None else valid_frames * f_in
        with tracing.span("semamba.encoder"):
            out = self.dense_encoder(x, n_valid, keep)
        for i, block in enumerate(self.TSMamba, start=1):
            with tracing.span("semamba.tfmamba", i):
                out = block(out, keep, n_time, n_freq, tokens)
        with tracing.span("semamba.decoders"):
            mask = self.mask_decoder(out, n_valid, keep)
            pha = self.phase_decoder(out, n_valid, keep)
        return mask * x[:, 0:1], pha


def create_semamba(config: Optional[Dict] = None) -> SEMamba:
    """A ``SEMamba`` in eval mode from the merged config's ``model`` section
    (``hid_feature``, ``num_tfmamba``, ``d_state``, ``d_conv``, ``expand``,
    ``norm_epsilon``, ``beta``, ``compress_factor``; the recipe's values by
    default) and the
    ``audio`` section's ``n_fft`` (``n_fft // 2 + 1`` bins)."""
    config = config or {}
    mc = config.get("model", {})
    model = SEMamba(
        hid_feature=mc.get("hid_feature", 64), num_tfmamba=mc.get("num_tfmamba", 4),
        d_state=mc.get("d_state", 16), d_conv=mc.get("d_conv", 4), expand=mc.get("expand", 4),
        norm_epsilon=mc.get("norm_epsilon", 1e-5), n_fft=config.get("audio", {}).get("n_fft", 400),
        beta=mc.get("beta", 2.0), compress_factor=mc.get("compress_factor", 0.3),
    )
    return model.eval()
