"""CMGAN's generator, ``TSCNet`` (Cao, Abdulatif and Yang, "CMGAN:
Conformer-based Metric GAN for Speech Enhancement", Interspeech 2022,
arXiv:2203.15149; the authors' ``src/models/generator.py`` and
``conformer.py``), for inference on the port's enhancer.

Layout ``[B, C, T, F]`` as the authors': ``x [B, 2, T, 201]`` is the real and
imaginary part of the power-compressed STFT (400/100 Hamming); the output is
``(Y_re, Y_im)``, each ``[B, 1, T, 201]``. Modules are named as the authors
name them, so that their checkpoint's ``state_dict`` loads as it is:
``dense_encoder``, ``TSCB_1`` .. ``TSCB_4`` (``time_conformer``,
``freq_conformer``: ``ff1.fn.fn.net``, ``attn.fn.to_q`` / ``to_kv`` /
``to_out`` / ``rel_pos_emb``, ``conv.net``, ``ff2``, ``post_norm``),
``mask_decoder``, ``complex_decoder``.

Length masking, which the authors do not have (they run one clip at a
time): ``n_valid [B]`` frames of each row are real and the rest bucket
padding. Every InstanceNorm takes its statistics over the valid frames, the
time attention masks the padded keys, and the padded frames are zeroed
before each depthwise convolution; the dilated convolutions are causal in
time, and the frequency attention and the sub-pixel convolutions act within
a frame, so a clip's output does not depend on the bucket it is padded to.

The attention is relative-position attention through
``ops.cuda_attention.attention_relpos`` (kernel K2r on CUDA), and each of a
conformer block's sublayer boundaries (the residual add, the half step's
scale, the next LayerNorm and, at the block's end, TSCB's outer residual)
one call of ``ops.cuda_layer_norm.add_layer_norm`` (kernel
``add_layer_norm`` on CUDA; on the CPU the unfused ATen calls), and each
InstanceNorm with the PReLU after it (16 a forward) one call of
``ops.cuda_instance_norm.instance_norm_prelu`` (kernel ``instance_norm`` on
CUDA; on the CPU the unfused ATen calls), all forward only: the model
refuses training mode.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda_attention import attention_relpos
from ..ops.cuda_instance_norm import instance_norm_prelu
from ..ops.cuda_layer_norm import add_layer_norm
from ..utils import tracing


class Swish(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(x)


class _ChannelsFirst(nn.Module):
    """The authors' ``Rearrange`` between ``[B, N, C]`` and ``[B, C, N]``."""

    def forward(self, x):
        return x.transpose(1, 2)


def norm_prelu(x: torch.Tensor, norm: nn.InstanceNorm2d, prelu: nn.PReLU,
               n_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """``prelu(norm(x))`` over ``[B, C, T, F]``, the affine InstanceNorm's
    mean and biased variance over the valid frames (the first ``n_valid[b]``
    of each row, int32 ``[B]``; None: all) only, every frame normalised by
    them: one ``instance_norm_prelu`` call; counts
    ``cmgan.instance_norm_calls``."""
    tracing.count("cmgan.instance_norm_calls")
    return instance_norm_prelu(x, n_valid, norm.weight, norm.bias, prelu.weight, norm.eps)


class DilatedDenseNet(nn.Module):
    def __init__(self, depth: int = 4, in_channels: int = 64):
        super().__init__()
        self.depth = depth
        self.in_channels = in_channels
        self.twidth = 2
        self.kernel_size = (self.twidth, 3)
        for i in range(depth):
            dil = 2 ** i
            pad_length = self.twidth + (dil - 1) * (self.twidth - 1) - 1
            setattr(self, f"pad{i + 1}", nn.ConstantPad2d((1, 1, pad_length, 0), value=0.0))
            setattr(self, f"conv{i + 1}", nn.Conv2d(in_channels * (i + 1), in_channels,
                                                    kernel_size=self.kernel_size,
                                                    dilation=(dil, 1)))
            setattr(self, f"norm{i + 1}", nn.InstanceNorm2d(in_channels, affine=True))
            setattr(self, f"prelu{i + 1}", nn.PReLU(in_channels))

    def forward(self, x, n_valid=None):
        skip = x
        for i in range(1, self.depth + 1):
            out = getattr(self, f"conv{i}")(getattr(self, f"pad{i}")(skip))
            out = norm_prelu(out, getattr(self, f"norm{i}"), getattr(self, f"prelu{i}"), n_valid)
            skip = torch.cat([out, skip], dim=1)
        return out


class DenseEncoder(nn.Module):
    def __init__(self, in_channel: int, channels: int = 64):
        super().__init__()
        self.conv_1 = nn.Sequential(
            nn.Conv2d(in_channel, channels, (1, 1), (1, 1)),
            nn.InstanceNorm2d(channels, affine=True),
            nn.PReLU(channels),
        )
        self.dilated_dense = DilatedDenseNet(depth=4, in_channels=channels)
        self.conv_2 = nn.Sequential(
            nn.Conv2d(channels, channels, (1, 3), (1, 2), padding=(0, 1)),
            nn.InstanceNorm2d(channels, affine=True),
            nn.PReLU(channels),
        )

    @staticmethod
    def _block(seq: nn.Sequential, x, n_valid):
        return norm_prelu(seq[0](x), seq[1], seq[2], n_valid)

    def forward(self, x, n_valid=None):
        x = self._block(self.conv_1, x, n_valid)
        x = self.dilated_dense(x, n_valid)
        return self._block(self.conv_2, x, n_valid)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, dim * mult), Swish(), nn.Dropout(dropout),
                                 nn.Linear(dim * mult, dim), nn.Dropout(dropout))

    def forward(self, x, **kwargs):
        return self.net(x)


class Attention(nn.Module):
    """Multi-head self-attention with Shaw's relative positions, offsets
    clamped at +-``max_pos_emb``, one table shared by the heads."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 max_pos_emb: int = 512):
        super().__init__()
        inner = dim_head * heads
        self.heads = heads
        self.scale = dim_head ** -0.5
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim)
        self.max_pos_emb = max_pos_emb
        self.rel_pos_emb = nn.Embedding(2 * max_pos_emb + 1, dim_head)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, mask=None, kept_keys=None):
        g, n, _ = x.shape
        h = self.heads
        q = self.to_q(x)
        k, v = self.to_kv(x).chunk(2, dim=-1)
        q, k, v = (t.reshape(g, n, h, -1).transpose(1, 2).contiguous() for t in (q, k, v))
        out = attention_relpos(q, k, v, self.rel_pos_emb.weight, self.max_pos_emb,
                               scale=self.scale, mask=mask, kept_keys=kept_keys)
        return self.dropout(self.to_out(out.transpose(1, 2).reshape(g, n, -1)))


class DepthWiseConv1d(nn.Module):
    def __init__(self, chan_in: int, chan_out: int, kernel_size: int, padding):
        super().__init__()
        self.padding = padding
        self.conv = nn.Conv1d(chan_in, chan_out, kernel_size, groups=chan_in)

    def forward(self, x):
        return self.conv(F.pad(x, self.padding))


class ConformerConvModule(nn.Module):
    def __init__(self, dim: int, expansion_factor: int = 2, kernel_size: int = 31,
                 dropout: float = 0.0):
        super().__init__()
        inner = dim * expansion_factor
        pad = kernel_size // 2
        self.net = nn.Sequential(
            nn.LayerNorm(dim),
            _ChannelsFirst(),
            nn.Conv1d(dim, inner * 2, 1),
            nn.GLU(dim=1),
            DepthWiseConv1d(inner, inner, kernel_size=kernel_size,
                            padding=(pad, pad - (kernel_size + 1) % 2)),
            nn.BatchNorm1d(inner),
            Swish(),
            nn.Conv1d(inner, dim, 1),
            _ChannelsFirst(),
            nn.Dropout(dropout),
        )

    def forward(self, h, valid=None):
        """The module after its LayerNorm (``net[0]``, which the block applies
        at its sublayer boundary) and before its last transpose (``net[8]``):
        ``h [G, N, C]``, normalised, to ``[G, C, N]``. ``valid [G, 1, N]``
        float: the positions kept; the others are zeroed before the
        depthwise convolution."""
        net = self.net
        y = net[3](net[2](net[1](h)))
        if valid is not None:
            y = y * valid
        for layer in net[4:8]:
            y = layer(y)
        return net[9](y)


class PreNorm(nn.Module):
    """The authors' ``PreNorm``: ``fn`` after ``norm``, which the block
    applies at its sublayer boundary."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.norm = nn.LayerNorm(dim)


class Scale(nn.Module):
    """The authors' ``Scale``: ``fn``'s output times ``scale``, which the
    block applies at its sublayer boundary."""

    def __init__(self, scale: float, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.scale = scale


def _add_norm(x, delta, norm: nn.LayerNorm, **kw):
    """One sublayer boundary, ``add_layer_norm`` with ``norm``'s parameters;
    counts ``cmgan.add_norm_calls``."""
    tracing.count("cmgan.add_norm_calls")
    return add_layer_norm(x, delta, norm.weight, norm.bias, norm.eps, **kw)


class ConformerBlock(nn.Module):
    def __init__(self, *, dim: int, dim_head: int = 64, heads: int = 8, ff_mult: int = 4,
                 conv_expansion_factor: int = 2, conv_kernel_size: int = 31,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0, conv_dropout: float = 0.0,
                 max_pos_emb: int = 512):
        super().__init__()
        self.ff1 = Scale(0.5, PreNorm(dim, FeedForward(dim, ff_mult, ff_dropout)))
        self.attn = PreNorm(dim, Attention(dim, heads, dim_head, attn_dropout, max_pos_emb))
        self.conv = ConformerConvModule(dim, conv_expansion_factor, conv_kernel_size,
                                        conv_dropout)
        self.ff2 = Scale(0.5, PreNorm(dim, FeedForward(dim, ff_mult, ff_dropout)))
        self.post_norm = nn.LayerNorm(dim)

    def forward(self, x, mask=None, kept_keys=None, residual=None):
        """``post_norm(x3 + ff2(x3) / 2)`` (plus ``residual``, where given)
        of ``x1 = x + ff1(x) / 2``, ``x2 = x1 + attn(x1)``, ``x3 = x2 +
        conv(x2)``, each sublayer after its LayerNorm: five boundaries, each
        one ``add_layer_norm`` call."""
        ff1, attn, conv, ff2 = self.ff1, self.attn, self.conv, self.ff2
        _, h = _add_norm(x, None, ff1.fn.norm)
        x, h = _add_norm(x, ff1.fn.fn(h), attn.norm, scale=ff1.scale, keep_sum=True)
        x, h = _add_norm(x, attn.fn(h, mask=mask, kept_keys=kept_keys), conv.net[0],
                         keep_sum=True)
        valid = None if mask is None else mask[:, None, :].to(x.dtype)
        x, h = _add_norm(x, conv(h, valid), ff2.fn.norm, channels_first=True, keep_sum=True)
        return _add_norm(x, ff2.fn.fn(h), self.post_norm, scale=ff2.scale, residual=residual)[1]


class TSCB(nn.Module):
    """Two-stage conformer block: a conformer over time for each frequency
    bin, then one over frequency for each frame, each residual."""

    def __init__(self, num_channel: int = 64, heads: int = 4, ff_mult: int = 4,
                 conv_expansion_factor: int = 2, conv_kernel_size: int = 31,
                 max_pos_emb: int = 512):
        super().__init__()
        kw = dict(dim=num_channel, dim_head=num_channel // heads, heads=heads, ff_mult=ff_mult,
                  conv_expansion_factor=conv_expansion_factor,
                  conv_kernel_size=conv_kernel_size, attn_dropout=0.2, ff_dropout=0.2,
                  max_pos_emb=max_pos_emb)
        self.time_conformer = ConformerBlock(**kw)
        self.freq_conformer = ConformerBlock(**kw)

    def forward(self, x_in, frames=None, kept_frames=None):
        """``frames [B, T]`` bool, the valid frames; ``kept_frames`` their
        count summed over the batch, where the host knows it (counters)."""
        b, c, t, f = x_in.shape
        x_t = x_in.permute(0, 3, 2, 1).contiguous().view(b * f, t, c)
        mask = None if frames is None else frames[:, None, :].expand(b, f, t).reshape(b * f, t)
        kept = None if kept_frames is None else kept_frames * f
        x_t = self.time_conformer(x_t, mask=mask, kept_keys=kept, residual=x_t)
        x_f = x_t.view(b, f, t, c).permute(0, 2, 1, 3).contiguous().view(b * t, f, c)
        x_f = self.freq_conformer(x_f, residual=x_f)
        return x_f.view(b, t, f, c).permute(0, 3, 1, 2)


class SPConvTranspose2d(nn.Module):
    """Sub-pixel transposed convolution along frequency: a conv to ``r``
    times the channels, interleaved along the last axis."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, r: int = 1):
        super().__init__()
        self.pad1 = nn.ConstantPad2d((1, 1, 0, 0), value=0.0)
        self.out_channels = out_channels
        self.conv = nn.Conv2d(in_channels, out_channels * r, kernel_size=kernel_size,
                              stride=(1, 1))
        self.r = r

    def forward(self, x):
        out = self.conv(self.pad1(x))
        b, nch, h, w = out.shape
        out = out.view(b, self.r, nch // self.r, h, w).permute(0, 2, 3, 4, 1)
        return out.contiguous().view(b, nch // self.r, h, -1)


class MaskDecoder(nn.Module):
    def __init__(self, num_features: int, num_channel: int = 64, out_channel: int = 1):
        super().__init__()
        self.dense_block = DilatedDenseNet(depth=4, in_channels=num_channel)
        self.sub_pixel = SPConvTranspose2d(num_channel, num_channel, (1, 3), 2)
        self.conv_1 = nn.Conv2d(num_channel, out_channel, (1, 2))
        self.norm = nn.InstanceNorm2d(out_channel, affine=True)
        self.prelu = nn.PReLU(out_channel)
        self.final_conv = nn.Conv2d(out_channel, out_channel, (1, 1))
        self.prelu_out = nn.PReLU(num_features, init=-0.25)

    def forward(self, x, n_valid=None):
        x = self.sub_pixel(self.dense_block(x, n_valid))
        x = norm_prelu(self.conv_1(x), self.norm, self.prelu, n_valid)
        x = self.final_conv(x).permute(0, 3, 2, 1).squeeze(-1)
        return self.prelu_out(x).permute(0, 2, 1).unsqueeze(1)


class ComplexDecoder(nn.Module):
    def __init__(self, num_channel: int = 64):
        super().__init__()
        self.dense_block = DilatedDenseNet(depth=4, in_channels=num_channel)
        self.sub_pixel = SPConvTranspose2d(num_channel, num_channel, (1, 3), 2)
        self.prelu = nn.PReLU(num_channel)
        self.norm = nn.InstanceNorm2d(num_channel, affine=True)
        self.conv = nn.Conv2d(num_channel, 2, (1, 2))

    def forward(self, x, n_valid=None):
        x = self.sub_pixel(self.dense_block(x, n_valid))
        return self.conv(norm_prelu(x, self.norm, self.prelu, n_valid))


class TSCNet(nn.Module):
    """CMGAN's generator: ``forward(x, n_valid=None, kept_frames=None)``.

    ``x [B, 2, T, F]`` the compressed spectrum's real and imaginary parts;
    ``n_valid [B]`` (int, on x's device) the valid frames of each row, or
    None for all; ``kept_frames``, the host's sum of ``n_valid``, feeds the
    counters (``cmgan.true_frames``, ``cmgan.padded_frames`` and K2r's
    pairs) without reading the device. Returns ``(Y_re, Y_im)``."""

    def __init__(self, num_channel: int = 64, num_features: int = 201, num_tscb: int = 4,
                 heads: int = 4, ff_mult: int = 4, conv_expansion_factor: int = 2,
                 conv_kernel_size: int = 31, max_pos_emb: int = 512, dense_depth: int = 4):
        super().__init__()
        if dense_depth != 4:
            raise ValueError(f"CMGAN's DilatedDenseNet has depth 4, got {dense_depth}")
        self.num_features = num_features
        self.dense_encoder = DenseEncoder(in_channel=3, channels=num_channel)
        for i in range(1, num_tscb + 1):
            setattr(self, f"TSCB_{i}", TSCB(num_channel, heads, ff_mult, conv_expansion_factor,
                                            conv_kernel_size, max_pos_emb))
        self.num_tscb = num_tscb
        self.mask_decoder = MaskDecoder(num_features, num_channel=num_channel, out_channel=1)
        self.complex_decoder = ComplexDecoder(num_channel=num_channel)

    def forward(self, x, n_valid=None, kept_frames=None):
        if self.training:
            raise RuntimeError("TSCNet runs for inference only (eval mode): its attention "
                               "kernel K2r has no backward; CMGAN training is a ROADMAP item")
        b, _, t, _ = x.shape
        frames = None
        if n_valid is not None:
            n_valid = n_valid.to(device=x.device, dtype=torch.int32)
            frames = torch.arange(t, device=x.device)[None, :] < n_valid[:, None]
        if kept_frames is not None:
            tracing.count("cmgan.true_frames", int(kept_frames))
            tracing.count("cmgan.padded_frames", b * t)
        mag = torch.sqrt(x[:, 0] ** 2 + x[:, 1] ** 2).unsqueeze(1)
        phase = torch.atan2(x[:, 1], x[:, 0]).unsqueeze(1)
        with tracing.span("cmgan.encoder"):
            out = self.dense_encoder(torch.cat([mag, x], dim=1), n_valid)
        for i in range(1, self.num_tscb + 1):
            with tracing.span("cmgan.tscb", i):
                out = getattr(self, f"TSCB_{i}")(out, frames, kept_frames)
        with tracing.span("cmgan.decoders"):
            mask = self.mask_decoder(out, n_valid)
            complex_out = self.complex_decoder(out, n_valid)
        out_mag = mask * mag
        return (out_mag * torch.cos(phase) + complex_out[:, 0:1],
                out_mag * torch.sin(phase) + complex_out[:, 1:2])


def create_cmgan(config: Optional[Dict] = None) -> TSCNet:
    """A ``TSCNet`` in eval mode from the merged config's ``model`` section
    (``channels``, ``num_tscb``, ``heads``, ``ff_mult``,
    ``conv_expansion_factor``, ``conv_kernel_size``, ``max_pos_emb``,
    ``dense_depth``; the authors' values by default) and the ``audio``
    section's ``n_fft`` (``n_fft // 2 + 1`` bins)."""
    config = config or {}
    mc = config.get("model", {})
    n_fft = config.get("audio", {}).get("n_fft", 400)
    model = TSCNet(
        num_channel=mc.get("channels", 64), num_features=n_fft // 2 + 1,
        num_tscb=mc.get("num_tscb", 4), heads=mc.get("heads", 4),
        ff_mult=mc.get("ff_mult", 4), conv_expansion_factor=mc.get("conv_expansion_factor", 2),
        conv_kernel_size=mc.get("conv_kernel_size", 31), max_pos_emb=mc.get("max_pos_emb", 512),
        dense_depth=mc.get("dense_depth", 4),
    )
    return model.eval()
