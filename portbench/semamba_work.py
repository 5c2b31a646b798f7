"""SEMamba's analytic work, frozen so that a change to the program cannot
move the yardstick: the generator's forward FLOPs (a frozen copy of the
port's ``tools/flops.py`` ``semamba_forward_flops``, term for term;
multiply-add = 2 FLOPs; norms, activations, exponentials and the arithmetic
around the model not counted), one enhancement batch (the forward, and
``work.stft_work``'s STFT and iSTFT), and the selective scan's operations
and bytes.

Widths are the configuration's (``configs/semamba.json``): 64 channels,
four TFMamba blocks of a bidirectional Mamba-1 over time and one over
frequency (d_state 16, d_conv 4, expand 4: d_inner 256, dt_rank 4),
DenseBlocks of depth 4 with (3, 3) kernels, 201 bins in and out and 100
inside. The projections and convolutions run over every frame of the
bucket; the scans over the valid (frame, bin) pairs only (the time scans
over each row's valid frames, the frequency scans over the valid frames).

The scan's bound, call by call: its bytes are u, delta and z (d_inner
floats each) and B and C (d_state each) read and y (d_inner) written once a
valid step; its operations are its exponentials and logarithms (d_state
decays, and the softplus's exp and log and the SiLU's exp: d_state + 3 a
channel and step), each counted as 16 operations at fp32's 67 TFLOP/s:
sm_90's SFU issues 16 of them a clock an SM where its FMA pipe issues 256
FLOPs. The scan's multiply-adds (6 d_state + 4 a channel and step) run on
the FMA pipe beside the SFU and take less time than its exponentials, so
they are left out of the bound, which stays a least time.
"""

from __future__ import annotations

import math
from typing import Sequence

from .work import num_frames, stft_work

SFU_OPS = 16  # FMA-pipe FLOPs a clock an SM over SFU operations a clock an SM, sm_90


def _widths(model: dict) -> tuple:
    c = int(model["hid_feature"])
    inner = c * int(model["expand"])
    return (c, int(model["num_tfmamba"]), int(model["d_state"]), int(model["d_conv"]), inner,
            math.ceil(c / 16))


def _dense_flops(t: int, f: int, c: int) -> float:
    """A DenseBlock of depth 4 at ``t`` frames and ``f`` bins: conv i takes
    ``c * (i + 1)`` channels to ``c`` with a (3, 3) kernel."""
    return sum(2.0 * t * f * c * (i + 1) * c * 9 for i in range(4))


def mamba_token_flops(model: dict) -> float:
    """One direction's Mamba layer a token, the scan left out: in_proj, the
    depthwise conv, x_proj, dt_proj and out_proj."""
    c, _, n, k, inner, rank = _widths(model)
    return (2.0 * c * 2 * inner + 2.0 * inner * k + 2.0 * inner * (rank + 2 * n)
            + 2.0 * rank * inner + 2.0 * inner * c)


def scan_step_flops(model: dict) -> float:
    """The scan's multiply-adds a step: per channel and state delta * A,
    the decay times the state plus delta u B, and C h summed; per channel
    delta u, D u added and the gate."""
    _, _, n, _, inner, _ = _widths(model)
    return inner * (6.0 * n + 4.0)


def forward_flops(model: dict, batch: int, frames: int, f_bins: int = 201,
                  valid: Sequence[int] | None = None) -> dict:
    """Forward FLOPs of ``SEMamba`` on ``[batch, 2, frames, f_bins]``, by
    part; ``valid``: each row's valid frames (the scans' steps), all of
    them when None."""
    c, n_blocks, _, _, _, _ = _widths(model)
    t, f2 = frames, (f_bins - 3) // 2 + 1
    kept = batch * t if valid is None else sum(min(int(v), t) for v in valid)
    out = {}
    out["encoder"] = batch * (2.0 * t * f_bins * 2 * c + _dense_flops(t, f_bins, c)
                              + 2.0 * t * f2 * c * c * 3)
    out["mamba"] = n_blocks * 4 * batch * t * f2 * mamba_token_flops(model)
    out["scans"] = n_blocks * 4 * kept * f2 * scan_step_flops(model)
    out["linear"] = n_blocks * 2 * batch * t * f2 * 2.0 * 2 * c * c  # tlinear, flinear
    conv_t = 2.0 * t * f2 * c * c * 3
    out["decoders"] = batch * (2 * (_dense_flops(t, f2, c) + conv_t)
                               + 2.0 * t * f_bins * c + 2.0 * t * f_bins  # mask_conv 1x1s
                               + 2 * 2.0 * t * f_bins * c)                # phase_conv_r, _i
    out["total"] = float(sum(out.values()))
    return out


def _valid(config: dict, rows: int, wav_len: int, lengths) -> tuple:
    a = config["audio"]
    n_fft, hop = int(a["n_fft"]), int(a["hop_length"])
    frames = num_frames(n_fft, hop, wav_len)
    valid = None
    if lengths is not None and config.get("mask_padding"):
        valid = [min(1 + int(n) // hop, frames) for n in lengths]
    return n_fft, hop, frames, valid


def enhance_flops(config: dict, rows: int, wav_len: int,
                  lengths: Sequence[int] | None = None) -> float:
    """One enhancement batch of ``rows`` clips padded to ``wav_len``
    samples: the forward at its frames (the scans over the valid ones from
    ``lengths`` under ``mask_padding``), the STFT and the iSTFT."""
    n_fft, hop, frames, valid = _valid(config, rows, wav_len, lengths)
    w = stft_work(n_fft, hop, rows, wav_len)
    fwd = forward_flops(config["model"], rows, frames, n_fft // 2 + 1, valid)["total"]
    return fwd + w["stft"][0] + w["istft"][0]


def scan_work(config: dict, rows: int, wav_len: int,
              lengths: Sequence[int] | None = None) -> list:
    """``(operations, bytes)`` of each ``selective_scan`` call of one batch
    (per block: time forward, time backward, frequency forward, frequency
    backward), over the valid (frame, bin) pairs (the module docstring)."""
    m = config["model"]
    n_fft, hop, frames, valid = _valid(config, rows, wav_len, lengths)
    _, n_blocks, n, _, inner, _ = _widths(m)
    f2 = (n_fft // 2 + 1 - 3) // 2 + 1
    steps = (rows * frames if valid is None else sum(valid)) * f2
    call = (SFU_OPS * (n + 3.0) * inner * steps, 4.0 * (4 * inner + 2 * n) * steps)
    return [call] * (4 * n_blocks)
