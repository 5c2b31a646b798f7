"""CMGAN's analytic work, frozen so that a change to the program cannot move
the yardstick: the generator's forward FLOPs (a frozen copy of the port's
``tools/flops.py`` ``cmgan_forward_flops``, term for term; multiply-add = 2
FLOPs; norms, activations and the complex arithmetic around the model not
counted), one enhancement batch (the forward, and ``work.stft_work``'s STFT
and iSTFT), and K2r's operations and bytes.

Widths are the configuration's (``configs/cmgan.json``): 64 channels, four
two-stage conformer blocks of 4 heads x 16, feed-forward 256, conv expansion
2 and kernel 31, DenseNets of depth 4 with (2, 3) kernels, 201 bins in and
out and 101 inside. Time attention queries every frame and keys the valid
ones of its row; frequency attention keys all 101 bins.
"""

from __future__ import annotations

from typing import Sequence

from .work import num_frames, stft_work


def _widths(model: dict) -> tuple:
    return (int(model["channels"]), int(model["num_tscb"]), int(model["heads"]),
            int(model["ff_mult"]), int(model["conv_expansion_factor"]),
            int(model["conv_kernel_size"]))


def _dense_flops(t: int, f: int, c: int) -> float:
    """A DilatedDenseNet of depth 4 at ``t`` frames and ``f`` bins: conv i
    takes ``c * (i + 1)`` channels to ``c`` with a (2, 3) kernel."""
    return sum(2.0 * t * f * c * (i + 1) * c * 6 for i in range(4))


def conformer_token_flops(model: dict) -> float:
    """A conformer's FLOPs a position, attention's core left out: two
    feed-forwards, the q, kv and out projections, the conv module's two
    pointwise convs and its depthwise one."""
    c, _, _, mult, exp, kern = _widths(model)
    inner = c * exp
    ff = 2 * (2.0 * c * mult * c * 2)
    proj = 2.0 * c * (c + 2 * c + c)
    conv = 2.0 * c * 2 * inner + 2.0 * inner * kern + 2.0 * inner * c
    return ff + proj + conv


def attention_ops(rows: int, heads: int, n: int, kept: float, d: int) -> float:
    """K2r's operations over ``rows`` rows of ``heads`` heads, ``n`` queries
    and ``kept`` kept keys each (Q K^T, the relative term and P V)."""
    return 6.0 * rows * heads * n * kept * d


def forward_flops(model: dict, batch: int, frames: int, f_bins: int = 201,
                  valid: Sequence[int] | None = None) -> dict:
    """Forward FLOPs of ``TSCNet`` on ``[batch, 2, frames, f_bins]``, by
    part; ``valid``: each row's valid frames (the time attention's kept
    keys), all of them when None."""
    c, n_tscb, heads, _, _, _ = _widths(model)
    d = c // heads
    t, f2 = frames, (f_bins + 1) // 2
    kept = [t] * batch if valid is None else [min(int(v), t) for v in valid]
    out = {}
    out["encoder"] = batch * (2.0 * t * f_bins * 3 * c + _dense_flops(t, f_bins, c)
                              + 2.0 * t * f2 * c * c * 3)
    out["conformers"] = batch * 2 * n_tscb * conformer_token_flops(model) * t * f2
    out["attention_time"] = n_tscb * sum(attention_ops(f2, heads, t, k, d) for k in kept)
    out["attention_freq"] = n_tscb * attention_ops(batch * t, heads, f2, f2, d)
    sub_pixel = 2.0 * t * f2 * c * 2 * c * 3
    out["decoders"] = batch * (2 * (_dense_flops(t, f2, c) + sub_pixel)
                               + 2.0 * t * f_bins * c * 2          # mask conv_1 (1, 2)
                               + 2.0 * t * f_bins                  # mask final 1x1
                               + 2.0 * t * f_bins * c * 2 * 2)     # complex conv (1, 2)
    out["total"] = float(sum(out.values()))
    return out


def enhance_flops(config: dict, rows: int, wav_len: int,
                  lengths: Sequence[int] | None = None) -> float:
    """One enhancement batch of ``rows`` clips padded to ``wav_len``
    samples: the forward at its frames (the valid ones from ``lengths``
    under ``mask_padding``), the STFT and the iSTFT."""
    a = config["audio"]
    n_fft, hop = int(a["n_fft"]), int(a["hop_length"])
    frames = num_frames(n_fft, hop, wav_len)
    valid = None
    if lengths is not None and config.get("mask_padding"):
        valid = [1 + int(n) // hop for n in lengths]
    w = stft_work(n_fft, hop, rows, wav_len)
    fwd = forward_flops(config["model"], rows, frames, n_fft // 2 + 1, valid)["total"]
    return fwd + w["stft"][0] + w["istft"][0]


def relpos_work(config: dict, rows: int, wav_len: int,
                lengths: Sequence[int] | None = None) -> list:
    """``(operations, bytes)`` of each K2r call of one batch (per block, the
    time call, then the frequency call): operations over the kept keys;
    Q, K, V and O read or written once, fp32, and the table E."""
    m, a = config["model"], config["audio"]
    n_fft, hop = int(a["n_fft"]), int(a["hop_length"])
    c, n_tscb, heads, _, _, _ = _widths(m)
    d = c // heads
    t, f2 = num_frames(n_fft, hop, wav_len), (n_fft // 2 + 2) // 2
    kept = [t] * rows
    if lengths is not None and config.get("mask_padding"):
        kept = [min(1 + int(n) // hop, t) for n in lengths]
    table = 4.0 * (2 * int(m["max_pos_emb"]) + 1) * d
    time_call = (sum(attention_ops(f2, heads, t, k, d) for k in kept),
                 4.0 * 4 * rows * f2 * heads * t * d + table)
    freq_call = (attention_ops(rows * t, heads, f2, f2, d),
                 4.0 * 4 * rows * t * heads * f2 * d + table)
    return [time_call, freq_call] * n_tscb
