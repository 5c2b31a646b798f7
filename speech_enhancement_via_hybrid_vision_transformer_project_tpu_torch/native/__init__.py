"""ctypes bindings for the port's native C++ audio runtime.

``sevit_audio.cpp`` (beside this file) is compiled with the host compiler at
first use (``g++ -O3 -std=c++17 -fPIC -shared -pthread``) into
``build/torch_native/`` beside the package, named by a hash of the source and
the flags, and loaded with ``ctypes``. Importing this module builds nothing.

``available()`` is False when the build or the load fails; the first failure
warns once with the compiler's message, and callers (``data.wavio``) fall
back to the numpy codec. ``build()`` raises instead, for a caller that must
have the runtime.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "sevit_audio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_P = ctypes.c_void_p
_L = ctypes.c_long
_I = ctypes.c_int
_F = ctypes.c_float
_PI = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {  # name: (restype, argtypes)
    "sevit_wav_info": (_L, [ctypes.c_char_p, _PI]),
    "sevit_wav_read": (_L, [ctypes.c_char_p, _P, _L, _PI]),
    "sevit_wav_write": (_I, [ctypes.c_char_p, _P, _L, _I]),
    "sevit_peak_normalize": (_F, [_P, _L, _F]),
    "sevit_pre_emphasis": (None, [_P, _L, _F]),
    "sevit_decode_batch": (None, [ctypes.POINTER(ctypes.c_char_p), _L, _P, _L, _P, _P,
                                  _I, _F, _I]),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def library_path() -> Path:
    """Where the library is built: named by a hash of the source and flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libsevit_audio_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the runtime unless it is built from this exact source;
    raise ``RuntimeError`` with the compiler's message when that fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++ or c++ on PATH): the native audio "
                           "runtime cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}) on {SOURCE.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
                _error = str(e)
                warnings.warn(f"native audio runtime unavailable, using the numpy codec: "
                              f"{_error}", RuntimeWarning, stacklevel=3)
                return None
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def available() -> bool:
    """True when the runtime is built and loaded (building it at first use)."""
    return _load() is not None


def _library() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native audio runtime unavailable: {_error}")
    return lib


def _f32(x: np.ndarray, name: str) -> None:
    if x.dtype != np.float32 or not x.flags.c_contiguous or x.ndim != 1:
        raise ValueError(f"{name}: expected a contiguous 1-D float32 array")


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode one WAV to mono float32 (channels averaged)."""
    lib = _library()
    sr = ctypes.c_int(0)
    n = lib.sevit_wav_info(str(path).encode(), ctypes.byref(sr))
    if n < 0:
        raise OSError(f"native decode failed: {path}")
    buf = np.empty(n, np.float32)
    got = lib.sevit_wav_read(str(path).encode(), buf.ctypes.data, n, ctypes.byref(sr))
    if got < 0:
        raise OSError(f"native decode failed: {path}")
    return buf[:got], sr.value


def write_wav(path: str | Path, x: np.ndarray, sample_rate: int) -> None:
    """Write mono float32 samples as PCM16 (clipped to [-1, 1])."""
    lib = _library()
    x = np.ascontiguousarray(x, np.float32)
    _f32(x, "write_wav")
    if lib.sevit_wav_write(str(path).encode(), x.ctypes.data, len(x), sample_rate) != 0:
        raise OSError(f"native write failed: {path}")


def decode_batch(paths: Sequence[str | Path], max_len: int, *, normalize: bool = False,
                 target: float = 0.95, num_threads: int = 0
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode files on a thread pool into one zero-padded ``[B, max_len]``
    float32 matrix (each row cut at ``max_len``, peak-normalized to
    ``target`` when ``normalize``). Returns ``(batch, lengths,
    sample_rates)``; ``lengths[i]`` is -1 where file i failed."""
    lib = _library()
    count = len(paths)
    out = np.zeros((count, max_len), np.float32)
    lengths = np.zeros(count, np.int64)
    rates = np.zeros(count, np.int32)
    names = [str(p).encode() for p in paths]
    arr = (ctypes.c_char_p * count)(*names)
    lib.sevit_decode_batch(arr, count, out.ctypes.data, max_len, lengths.ctypes.data,
                           rates.ctypes.data, int(normalize), target, num_threads)
    return out, lengths, rates


def peak_normalize_inplace(x: np.ndarray, target: float = 0.95) -> float:
    """Scale ``x`` in place to peak ``target``; returns the old peak."""
    _f32(x, "peak_normalize_inplace")
    return _library().sevit_peak_normalize(x.ctypes.data, len(x), target)


def pre_emphasis_inplace(x: np.ndarray, coef: float = 0.97) -> None:
    """Pre-emphasis in place: ``y[n] = x[n] - coef * x[n - 1]``, ``y[0] = x[0]``."""
    _f32(x, "pre_emphasis_inplace")
    _library().sevit_pre_emphasis(x.ctypes.data, len(x), coef)
