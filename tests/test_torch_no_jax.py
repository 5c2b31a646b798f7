"""The PyTorch port stands alone: it imports nothing of JAX, and on the CPU
every kernel wrapper takes its plain version without touching the kernel
library.

The import check scans the source (AST), not ``sys.modules``: this test
process has JAX loaded already for the parity tests.
"""

import ast
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
    AudioEnhancer,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
    HybridViT,
    init_weights,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
    cuda_attention,
    cuda_stft,
    kernels,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "speech_enhancement_via_hybrid_vision_transformer_project_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_sources_found():
    assert len(SOURCES) > 15 and (PORT / "csrc" / "attention.cu").exists()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_cpu_tensors_take_the_plain_versions():
    """Kernel wrappers on CPU tensors (and a whole CPU enhancement) launch
    nothing and never load or build the kernel library."""
    kernels.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    re, im, mag = cuda_stft.stft_mag(torch.randn(2, 4000, generator=g))
    y = cuda_stft.istft_polar(mag, torch.atan2(im, re), length=4000)
    q = torch.randn(2, 2, 9, 8, generator=g)
    cuda_attention.attention(q, q, q, scale=8**-0.5, mask=torch.ones(2, 9, dtype=torch.bool))
    model = init_weights(HybridViT(embed_dim=32, num_heads=2, num_layers=1, mlp_ratio=2.0,
                                   encoder_channels=(8, 16, 32), decoder_channels=(16, 8, 8, 1)),
                         g)
    out = AudioEnhancer(model, {"model": {"output_mode": "mask"}}, device="cpu",
                        buckets=(64,)).enhance_batch([np.zeros(5000, np.float32)])
    assert y.shape == (2, 4000) and out[0].shape == (5000,)
    assert kernels.launched() == {}
    assert kernels._lib is None


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor on neither the CPU nor a CUDA device
    is refused, not computed by the plain version."""
    x = torch.empty(2, 4000, device="meta")
    with pytest.raises(ValueError, match="device"):
        cuda_stft.stft_mag(x)
    m = torch.empty(2, 257, 30, device="meta")
    with pytest.raises(ValueError, match="device"):
        cuda_stft.istft_polar(m, m)
    q = torch.empty(1, 2, 9, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        cuda_attention.attention(q, q, q, scale=1.0)


# kernels whose JAX counterpart is XLA-compiled code, not a pl.pallas_call:
# they name that function (public, so "def " without the underscore)
XLA_REPLACED = {"global_sq_norm": "chain_with_clip", "adam_update": "chain_with_clip"}


def test_kernel_registry_names_sources_and_tpu_kernels():
    assert kernels.NO_TPU_KERNEL.startswith("none:")
    for k in kernels.KERNELS.values():
        assert (PORT / k.source).exists()
        if k.replaces == kernels.NO_TPU_KERNEL:  # CMGAN's and SEMamba's kernels
            continue
        file, line = k.replaces.rsplit(":", 1)
        src = (ROOT / file).read_text().splitlines()
        if k.name in XLA_REPLACED:
            assert src[int(line) - 1].startswith(f"def {XLA_REPLACED[k.name]}("), k.replaces
        else:
            assert src[int(line) - 1].lstrip().startswith("def _"), k.replaces
    assert set(XLA_REPLACED) <= set(kernels.KERNELS)


def _c_argtypes(k: kernels.Kernel) -> tuple:
    """The ctypes of the parameters of ``k``'s ``extern "C"`` entry in its
    source: a pointer is ``c_void_p``, ``int`` ``c_int``, ``float``
    ``c_float``; the CUDA stream, a ``void*``, comes last."""
    src = (PORT / k.source).read_text()
    found = re.search(r'extern "C" int ' + re.escape(k.entry) + r"\(([^)]*)\)", src)
    assert found, f"{k.entry} not in {k.source}"
    params = [" ".join(p.split()) for p in found.group(1).split(",")]
    assert params[-1] == "void* stream", params
    scalars = {"int": ctypes.c_int, "float": ctypes.c_float}
    return tuple(ctypes.c_void_p if "*" in p else scalars[p.rsplit(" ", 1)[0]] for p in params)


@pytest.mark.parametrize("name", list(kernels.KERNELS))
def test_argtypes_match_the_c_entry(name):
    """A record's ``argtypes`` and its C entry's parameters, one for one."""
    k = kernels.KERNELS[name]
    assert k.argtypes == _c_argtypes(k)


def test_launched_leaves_out_kernels_at_zero(monkeypatch):
    for k in kernels.KERNELS.values():
        monkeypatch.setattr(k, "launches", 0)
    monkeypatch.setattr(kernels.KERNELS["stft_mag"], "launches", 2)
    monkeypatch.setattr(kernels.KERNELS["adam_update"], "launches", 1)
    assert kernels.launched() == {"stft_mag": 2, "adam_update": 1}
    kernels.reset_launch_counts()
    assert kernels.launched() == {}


def test_cpu_optimizer_takes_the_loop():
    """AdamW with the clip on CPU tensors: the plain loops, counted as
    ``optimizer.loop_steps``; no launch, no kernel library loaded."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.optimizer import (
        Optimizer,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils import tracing

    kernels.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    params = [torch.randn(5, 3, generator=g), torch.randn(7, generator=g)]
    grads = [torch.randn_like(p) for p in params]
    opt = Optimizer(params, "adamw", max_norm=1.0)
    before = tracing.counters()
    assert opt.step(grads)
    after = tracing.counters()
    assert after.get("optimizer.loop_steps", 0) == before.get("optimizer.loop_steps", 0) + 1
    assert after.get("optimizer.fused_steps", 0) == before.get("optimizer.fused_steps", 0)
    assert kernels.launched() == {}
    assert kernels._lib is None


def test_optimizer_kernels_refuse_other_devices():
    """A meta tensor is refused by both optimizer wrappers, not computed by
    their plain versions."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_optimizer,
    )

    x = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError, match="device"):
        cuda_optimizer.global_norm([x])
    with pytest.raises(ValueError, match="device"):
        cuda_optimizer.adam_update([x], [x], [x], [x], lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                                   weight_decay=0.01, adamw=True, count=1)


@pytest.mark.parametrize("rel", ["graft_entry.py", "cli/demo.py", "cli/synth_dataset.py"])
def test_the_entry_points_are_scanned(rel):
    """The entry points outside the package's CLIs (the counterparts of
    ``__graft_entry__.py``, ``examples/demo.py`` and
    ``scripts/synth_dataset.py``) are among the scanned sources."""
    assert PORT / rel in SOURCES
