"""Build, load and count the hand-written CUDA kernels.

The kernels in ``csrc/*.cu`` have a plain C interface. At first use each
source is compiled with ``nvcc`` for Hopper (``sm_90a``) into its own
shared library under ``build/torch_kernels/`` beside the package (the
compilers run in parallel), named by a hash of the source and of the
headers in ``csrc/`` so an edited source is rebuilt, and loaded with
``ctypes``. No
``--use_fast_math``: the STFT's ``sqrtf`` and the iSTFT's ``sincosf`` must
be the IEEE versions for parity with the plain PyTorch path.

Every C entry point takes device pointers and the CUDA stream as
``void*``, launches on that stream without synchronizing, and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0.

Each kernel has a ``Kernel`` record, the one statement of its C entry,
source and signature, with a plain launch counter that ``launch``
increments once per launch; ``launched()`` names the kernels that a run
launched, so a run can show that its main path went through them and
through no other.

Each kernel of the model's path is also reached through an operator of the
``sevit`` namespace of ``torch.library`` (``define_op``), so that
``torch.export`` records it as one call, ``torch.ops.sevit.<name>``, on
either device: its CUDA impl
launches the kernel, its CPU impl is the kernel's plain version, and its fake
impl gives the outputs' shapes and dtypes from the arguments alone. The STFT
kernels share two ops: ``sevit::stft_mag`` launches K1 (``stft_mag``) or K1g
(``stft_dft``), ``sevit::istft_polar`` K3 (``istft_polar``) or K3g
(``istft_dft``), as the STFT config decides (``cuda_stft.route``);
``sevit::attention_relpos_fwd`` launches CMGAN's K2r (``attention_relpos``),
``sevit::add_layer_norm`` its conformers' residual add and LayerNorm
(``add_layer_norm``) and ``sevit::instance_norm_prelu`` its masked
InstanceNorms with their PReLUs (``instance_norm``, three CUDA kernels a
launch), ``sevit::selective_scan`` SEMamba's selective scans
(``selective_scan``) and ``sevit::conv1d_silu`` its depthwise convs with
their SiLUs (``conv1d_silu``), kernels that port no TPU kernel
(``NO_TPU_KERNEL``).
A meta tensor is refused rather than given shapes as if it had been
computed. The ops are defined when ``cuda_stft``, ``cuda_attention``,
``cuda_layer_norm``, ``cuda_instance_norm`` and ``cuda_scan`` are imported
(``import`` of the port's ``ops`` package does all five); a program that ``torch.export`` saved needs them defined
before it is loaded. The optimizer's kernels
(``global_sq_norm`` and ``adam_update``, one source) update tensor lists in
place, belong to no exported program, and are called by their wrappers in
``cuda_optimizer`` without an op.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from dataclasses import dataclass
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# ``replaces`` of a kernel that ports no TPU kernel
NO_TPU_KERNEL = "none: no TPU kernel (the JAX package has no such model)"


@dataclass
class Kernel:
    """One hand-written kernel: its C entry, its source and the TPU kernel
    it replaces (``NO_TPU_KERNEL`` for one that ports none), and how often
    its wrapper has launched it."""

    name: str
    entry: str
    source: str
    replaces: str
    argtypes: tuple
    launches: int = 0


KERNELS = {
    k.name: k
    for k in (
        Kernel(
            "stft_mag", "sevit_stft_mag", "csrc/stft.cu",
            "speech_enhancement_via_hybrid_vision_transformer_project_tpu/"
            "ops/pallas_stft.py:31",
            # x, plan, re, im, mag, batch, length, pad, reflect, n_frames,
            # n_fft, hop, tile, radix plan, stream
            (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
        ),
        Kernel(
            "attention_fwd", "sevit_attention_fwd", "csrc/attention.cu",
            "speech_enhancement_via_hybrid_vision_transformer_project_tpu/"
            "ops/pallas_attention.py:46",
            # q, k, v, key_mask, out, lse, groups, heads, n, d,
            # scale * log2(e), stream
            (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
        ),
        Kernel(
            "attention_bwd", "sevit_attention_bwd", "csrc/attention_bwd.cu",
            "speech_enhancement_via_hybrid_vision_transformer_project_tpu/"
            "ops/pallas_attention.py:124",
            # q, k, v, o, dout, lse, key_mask, delta, dq, dk, dv, groups,
            # heads, n, d, scale * log2(e), scale, stream
            (_P,) * 11 + (_I, _I, _I, _I, _F, _F, _P),
        ),
        Kernel(
            "istft_polar", "sevit_istft_polar", "csrc/istft.cu",
            "speech_enhancement_via_hybrid_vision_transformer_project_tpu/"
            "ops/pallas_stft.py:185",
            # mag, phase, plan, denom, y, batch, n_frames, n_fft, hop,
            # offset, out_samples, tile, radix plan, stream
            (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
        ),
        Kernel(
            "stft_dft", "sevit_stft_dft", "csrc/stft_dft.cu",
            "speech_enhancement_via_hybrid_vision_transformer_project_tpu/"
            "ops/pallas_stft.py:31",
            # x, dft tiles, re, im, mag, batch, length, pad, reflect, n_frames,
            # n_fft, hop, tile bins, tile depth, stream
            (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
        ),
        Kernel(
            "istft_dft", "sevit_istft_dft", "csrc/istft_dft.cu",
            "speech_enhancement_via_hybrid_vision_transformer_project_tpu/"
            "ops/pallas_stft.py:185",
            # mag, phase, idft tiles, denom, frames, y, batch, n_frames, n_fft,
            # hop, offset, out_samples, tile samples, tile depth, stream
            (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
        ),
        # CMGAN's relative-position attention: the JAX package runs no CMGAN
        Kernel(
            "attention_relpos", "sevit_attention_relpos_fwd", "csrc/attention_relpos.cu",
            NO_TPU_KERNEL,
            # q, k, v, emb, key_mask, out, groups, heads, n, d, max_pos,
            # scale * log2(e), stream
            (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
        ),
        # CMGAN's conformer sublayer boundaries: a residual add and a LayerNorm
        Kernel(
            "add_layer_norm", "sevit_add_layer_norm", "csrc/add_layer_norm.cu",
            NO_TPU_KERNEL,
            # x, delta, residual, gamma, beta, sum, out, groups, n, scale, eps,
            # channels_first, stream
            (_P,) * 7 + (_I, _I, _F, _F, _I, _P),
        ),
        # CMGAN's masked InstanceNorms and their PReLUs: three CUDA kernels a call
        Kernel(
            "instance_norm", "sevit_instance_norm_prelu", "csrc/instance_norm.cu",
            NO_TPU_KERNEL,
            # x, n_valid, weight, bias, slope, scratch, out, batch, channels,
            # frames, bins, slopes, chunks, channels_last, eps, stream
            (_P,) * 7 + (_I,) * 7 + (_F, _P),
        ),
        # SEMamba's selective scans: the JAX package runs no SEMamba
        Kernel(
            "selective_scan", "sevit_selective_scan", "csrc/selective_scan.cu",
            NO_TPU_KERNEL,
            # u, delta, z, B, C, A_log, D, delta_bias, n_valid, y, seqs, steps,
            # channels, states, z_stride, bc_stride, reverse, stream
            (_P,) * 10 + (_I,) * 7 + (_P,),
        ),
        # SEMamba's depthwise convs with their SiLUs, either direction
        Kernel(
            "conv1d_silu", "sevit_conv1d_silu", "csrc/conv1d_silu.cu",
            NO_TPU_KERNEL,
            # x, weight, bias, u, seqs, steps, channels, width, x_stride,
            # reverse, stream
            (_P,) * 4 + (_I,) * 6 + (_P,),
        ),
        # the optimizer's chain: XLA-compiled code in the JAX package, no Pallas
        Kernel(
            "global_sq_norm", "sevit_global_sq_norm", "csrc/optimizer.cu",
            "speech_enhancement_via_hybrid_vision_transformer_project_tpu/"
            "training/optimizer.py:57",
            # pointers, numels (host arrays), count, chunk, partials, counter,
            # out, block offset, total blocks, stream
            (_P, _P, _I, _I, _P, _P, _P, _I, _I, _P),
        ),
        Kernel(
            "adam_update", "sevit_adam_update", "csrc/optimizer.cu",
            "speech_enhancement_via_hybrid_vision_transformer_project_tpu/"
            "training/optimizer.py:57",
            # p, g, m, v pointers and numels (host arrays), count, chunk, norm,
            # max_norm, b1, 1-b1, b2, 1-b2, 1/c1, 1/c2, eps, wd, -lr, adamw,
            # stream
            (_P,) * 5 + (_I, _I, _P) + (_F,) * 10 + (_I, _P),
        ),
    )
}

_lock = threading.Lock()
_lib: dict[str, ctypes.CDLL] | None = None


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launched() -> dict[str, int]:
    """``{name: launches}`` of the kernels launched since the counts were
    last reset, each at least once: a check that compares a path's launches
    with it names only the kernels that the path runs, and fails as well on
    one that runs where it should not."""
    return {name: k.launches for name, k in KERNELS.items() if k.launches}


def op_calls(program) -> dict[str, int]:
    """``{op: calls}`` of the ``sevit`` ops (``torch.ops.sevit.<op>``) in an
    exported program's graph, each called at least once."""
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    return {t.split(".")[1]: targets.count(t) for t in dict.fromkeys(targets)
            if t.startswith("sevit.")}


def uses_kernel(t: torch.Tensor) -> bool:
    """The wrappers' dispatch rule: True for a CUDA tensor (launch the
    kernel), False for a CPU tensor (run the plain version). Any other
    device is refused rather than computed by the plain version."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cuda"


def check_input(name: str, t: torch.Tensor, ndim: int, *, differentiable: bool = False) -> None:
    """Raise unless ``t`` is what the kernels take: float32 with ``ndim``
    dims, contiguous and, unless ``differentiable`` (K2, whose op has a
    backward), not requiring grad."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.requires_grad and not differentiable:
        raise RuntimeError(f"{name}: the CUDA kernel has no backward")


LIBRARY = torch.library.Library("sevit", "DEF")


def define_op(name: str, schema: str, *, cpu, cuda, fake):
    """Define ``torch.ops.sevit.<name>`` with signature ``schema`` (the
    part after the name): ``cuda`` launches the kernel, ``cpu`` is its plain
    version, ``fake`` gives the outputs' shapes and dtypes. Each device type
    is registered by name; a meta tensor raises. Returns the op."""
    LIBRARY.define(name + schema)
    LIBRARY.impl(name, cpu, "CPU")
    LIBRARY.impl(name, cuda, "CUDA")

    def fake_or_refuse(*args):
        # a tensor under torch.export's (or opcheck's) fake mode reports the
        # device it stands for; a meta tensor here was handed to the op itself
        if any(isinstance(a, torch.Tensor) and a.device.type == "meta" for a in args):
            raise ValueError(f"sevit::{name}: unsupported device meta (the op computes on "
                             "cpu or cuda)")
        return fake(*args)

    # PyTorch also makes the fake impl the op's Meta kernel
    torch.library.register_fake(f"sevit::{name}", fake_or_refuse, lib=LIBRARY)
    return getattr(torch.ops.sevit, name).default


def library_path(source: str) -> Path:
    """Where the shared library of one ``csrc/*.cu`` source is built,
    named by a hash of that source, the headers in ``csrc/`` and the
    flags."""
    src = _PKG / source
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot be "
        "built"
    )


def build() -> dict[str, Path]:
    """Compile each kernel source into its own shared library unless it
    is already built from that exact source: one ``nvcc`` per source, all
    started together. Returns the library path of each kernel (kernels of
    one source share it)."""
    paths = {name: library_path(k.source) for name, k in KERNELS.items()}
    sources = {k.source: paths[name] for name, k in KERNELS.items()}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source, out in sources.items():
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_PKG / source)]
        procs[source] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for source, (tmp, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{source} ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, sources[source])
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return paths


def library() -> dict[str, ctypes.CDLL]:
    """Each kernel's loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            libs = {}
            for name, path in build().items():
                lib = ctypes.CDLL(str(path))
                fn = getattr(lib, KERNELS[name].entry)
                fn.argtypes = list(KERNELS[name].argtypes)
                fn.restype = ctypes.c_int
                libs[name] = lib
            _lib = libs
        return _lib


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry on the current CUDA stream (appended
    as the last argument), raise on a launch error, count the launch."""
    k = KERNELS[name]
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library()[name], k.entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    k.launches += 1
