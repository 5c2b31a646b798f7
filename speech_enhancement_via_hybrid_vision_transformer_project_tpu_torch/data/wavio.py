"""WAV file I/O (the JAX package's ``data/wavio.py``).

RIFF/WAVE parsing of PCM 8/16/24/32-bit and IEEE float in numpy; mono
mixdown, optional resample, float32 in [-1, 1]. ``load_audio`` decodes
through the port's C++ runtime (``native/``) when it is built, and through
numpy otherwise.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from ..ops.audio import resample as _resample

_FMT_PCM = 1
_FMT_IEEE_FLOAT = 3
_FMT_EXTENSIBLE = 0xFFFE


def read_wav_raw(path: str | Path) -> tuple[np.ndarray, int]:
    """Parse a WAV file -> (float32 samples [n] or [n, ch], sample_rate)."""
    return decode_wav_bytes(Path(path).read_bytes(), name=str(path))


def decode_wav_bytes(data: bytes, name: str = "<bytes>") -> tuple[np.ndarray, int]:
    """Parse in-memory WAV bytes -> (float32 [n] or [n, ch], sample_rate)."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{name}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    payload = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            if len(body) < 16:
                raise ValueError(f"{name}: truncated fmt chunk")
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif cid == b"data":
            payload = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or payload is None:
        raise ValueError(f"{name}: missing fmt/data chunk")
    audio_fmt, n_ch, sr, _brate, _balign, bits = fmt
    if audio_fmt == _FMT_EXTENSIBLE:
        audio_fmt = _FMT_PCM if bits != 32 else _FMT_IEEE_FLOAT

    if audio_fmt == _FMT_IEEE_FLOAT:
        if bits not in (32, 64):
            raise ValueError(f"{name}: unsupported float bit depth {bits}")
        dt = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(payload[: len(payload) // (bits // 8) * (bits // 8)], dtype=dt)
        x = x.astype(np.float32)
    elif audio_fmt == _FMT_PCM:
        if bits == 16:
            x = np.frombuffer(payload[: len(payload) // 2 * 2], dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(payload[: len(payload) // 4 * 4], dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(payload, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(payload[: len(payload) // 3 * 3], dtype=np.uint8).reshape(-1, 3)
            vals = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"{name}: unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"{name}: unsupported WAV format {audio_fmt}")

    if n_ch > 1:
        x = x[: (len(x) // n_ch) * n_ch].reshape(-1, n_ch)
    return x, sr


def wav_info(path: str | Path) -> tuple[int, int, int]:
    """Header-only probe -> ``(n_samples_per_channel, sample_rate,
    channels)``. Seeks over chunk payloads, so probing a directory costs a
    few hundred bytes of I/O a file: ``enhance_directory`` and the evaluator
    length-sort large sweeps with it without decoding any audio."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data_size = None
        while fmt is None or data_size is None:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid = hdr[:4]
            (size,) = struct.unpack_from("<I", hdr, 4)
            if cid == b"fmt ":
                body = f.read(min(size, 16))
                if len(body) < 16:
                    raise ValueError(f"{path}: truncated fmt chunk")
                fmt = struct.unpack_from("<HHIIHH", body, 0)
                f.seek(size - 16 + (size & 1), 1)
            else:
                if cid == b"data":
                    data_size = size
                f.seek(size + (size & 1), 1)
    if fmt is None or data_size is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    _, n_ch, sr, _, block_align, bits = fmt
    bytes_per_frame = block_align or max(1, n_ch * (bits // 8))
    return data_size // bytes_per_frame, sr, n_ch


def _finish(x: np.ndarray, sr: int, sample_rate: int | None, mono: bool):
    if mono and x.ndim == 2:
        x = x.mean(axis=1)
    if sample_rate is not None and sr != sample_rate:
        x = _resample(x, sr, sample_rate)
        sr = sample_rate
    return np.ascontiguousarray(x, dtype=np.float32), sr


def load_audio(
    path: str | Path, sample_rate: int | None = 16000, mono: bool = True,
    use_native: bool = True,
) -> tuple[np.ndarray, int]:
    """Load a WAV file as float32; mono mixdown and resample to
    ``sample_rate`` (librosa.load semantics). Mono loads decode through the
    C++ runtime when ``use_native`` and it is built (a file it cannot decode
    goes to numpy, which names the fault); numpy otherwise."""
    if use_native and mono:
        from .. import native

        if native.available():
            try:
                x, sr = native.read_wav(path)
            except OSError:
                pass
            else:
                return _finish(x, sr, sample_rate, mono)
    return _finish(*read_wav_raw(path), sample_rate, mono)


def read_wav_bytes(
    data: bytes, sample_rate: int | None = 16000, mono: bool = True
) -> tuple[np.ndarray, int]:
    """In-memory counterpart of ``load_audio`` (serving path)."""
    x, sr = decode_wav_bytes(data)
    return _finish(x, sr, sample_rate, mono)


def wav_bytes(x: np.ndarray, sample_rate: int = 16000, subtype: str = "pcm16") -> bytes:
    """Encode a float waveform ``[n]`` or ``[n, ch]`` as WAV bytes."""
    x = np.asarray(x)
    if x.ndim == 1:
        n_ch = 1
    elif x.ndim == 2:
        n_ch = x.shape[1]
    else:
        raise ValueError("expected [n] or [n, ch] audio")
    if subtype == "pcm16":
        pcm = np.clip(x, -1.0, 1.0)
        payload = np.round(pcm * 32767.0).astype("<i2").tobytes()
        bits, fmt = 16, _FMT_PCM
    elif subtype == "float32":
        payload = x.astype("<f4").tobytes()
        bits, fmt = 32, _FMT_IEEE_FLOAT
    else:
        raise ValueError(f"unsupported subtype {subtype}")
    byte_rate = sample_rate * n_ch * bits // 8
    block_align = n_ch * bits // 8
    hdr = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    hdr += b"fmt " + struct.pack(
        "<IHHIIHH", 16, fmt, n_ch, sample_rate, byte_rate, block_align, bits
    )
    hdr += b"data" + struct.pack("<I", len(payload))
    return hdr + payload


def save_wav(path: str | Path, x: np.ndarray, sample_rate: int = 16000,
             subtype: str = "pcm16") -> None:
    """Write a mono/stereo float waveform to a WAV file."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(wav_bytes(x, sample_rate, subtype))
