"""The four kernels as ``torch.library`` ops (``torch.ops.sevit.*``) on the
CPU, where each op's impl is its kernel's plain version.

- ``torch.library.opcheck`` on each op (schema, autograd registration, fake
  impl against the real outputs, AOT dispatch), K2's gradient included.
- Each fake impl's shapes and dtypes against the plain version's over a
  grid of STFT configs and attention shapes.
- ``export_program`` on the CPU of a depth-2 model and of the enhancer core:
  the ``sevit`` ops in the graph, the loaded program equal to the eager
  module within 1e-6, and the loaded core against the JAX ``AudioEnhancer``
  on the same weights at the port's waveform limits (5e-5 float32, 1 PCM16
  LSB in int16: ``tests/test_torch_enhancer.py``).

No model is exported with fake CUDA tensors here: PyTorch built for the CPU
aborts the process in the device guard. The CUDA export is checked on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 13).
"""

import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.library import opcheck

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.inference.enhancer import (
    AudioEnhancer as JAudioEnhancer,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.models import (
    HybridViT as JHybridViT,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.utils.checkpoint import (
    load_model_weights as j_load_model_weights,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
    AudioEnhancer,
    EnhancerCore,
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
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import (
    STFTConfig,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
    export_program,
    load_model_weights,
    load_program,
    read_meta,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from fixtures.make_tiny_denoiser import TINY  # noqa: E402

torch.set_num_threads(2)

OPS = ("stft_mag", "attention_fwd", "attention_bwd", "istft_polar")
ATOL_EXPORT = 1e-6  # the loaded program against the eager module, one process
ATOL = 5e-5  # float32 waveforms against the JAX enhancer (test_torch_enhancer.py)
LSB = 1.0 / 32767.0
FIXTURE = Path(__file__).parent / "fixtures" / "tiny_denoiser_mask"
SR = 16000


def _cfg_args(cfg):
    return (cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.window, cfg.center, cfg.pad_mode)


def _qkv(rng, b, h, n, d, grad=False):
    return [torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(np.float32))
            .requires_grad_(grad) for _ in range(3)]


def _mask(kind, b, n, rng):
    if kind == "none":
        return None
    mask = rng.random((b, n)) > 0.4
    mask[:, 0] = True
    return torch.from_numpy(mask)


# ---------------------------------------------------------------------------
# the library: four ops, each with a CPU, a CUDA and a fake impl
# ---------------------------------------------------------------------------


def test_the_four_ops_are_registered_for_cpu_and_cuda_by_name():
    for name in OPS:
        op = getattr(torch.ops.sevit, name).default
        for key in ("CPU", "CUDA"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), key), (name, key)
        # no device-agnostic impl: nothing under CompositeExplicitAutograd or
        # CompositeImplicitAutograd would run a plain version on CUDA tensors
        for key in ("CompositeExplicitAutograd", "CompositeImplicitAutograd"):
            assert not torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), key), (name, key)
    assert torch._C._dispatch_has_kernel_for_dispatch_key("sevit::attention_fwd", "Autograd")


@pytest.mark.parametrize("name", OPS)
def test_a_meta_tensor_is_refused_not_given_shapes(name):
    op = getattr(torch.ops.sevit, name).default
    meta = torch.empty(1, 257, 9, device="meta")
    q = torch.empty(1, 2, 9, 16, device="meta")
    args = {
        "stft_mag": (torch.empty(1, 4000, device="meta"), *_cfg_args(STFTConfig())),
        "istft_polar": (meta, meta, *_cfg_args(STFTConfig()), None),
        "attention_fwd": (q, q, q, None, 0.25, False),
        "attention_bwd": (q, q, q, q, torch.empty(2, 9, device="meta"), q, None, 0.25),
    }[name]
    with pytest.raises(ValueError, match="meta"):
        op(*args)


# ---------------------------------------------------------------------------
# opcheck
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [STFTConfig(), STFTConfig(n_fft=256, hop_length=64, win_length=200),
                                 STFTConfig(center=False)], ids=["512", "256-win200", "no-center"])
def test_opcheck_stft_mag(cfg, rng):
    x = torch.from_numpy(rng.standard_normal((2, 3000)).astype(np.float32))
    opcheck(cuda_stft.stft_mag_op, (x, *_cfg_args(cfg)))


@pytest.mark.parametrize("length", [None, 2900], ids=["implied", "given"])
def test_opcheck_istft_polar(length, rng):
    cfg = STFTConfig()
    mag = torch.from_numpy(rng.random((2, 257, 24)).astype(np.float32))
    phase = torch.from_numpy(rng.uniform(-np.pi, np.pi, (2, 257, 24)).astype(np.float32))
    opcheck(cuda_stft.istft_polar_op, (mag, phase, *_cfg_args(cfg), length))


@pytest.mark.parametrize("with_lse", [True, False])
@pytest.mark.parametrize("kind", ["none", "partial"])
def test_opcheck_attention_fwd(with_lse, kind, rng):
    """With the log-sum-exp and inputs that require grad, opcheck also runs
    the op's autograd registration (its backward: ``sevit::attention_bwd``)."""
    q, k, v = _qkv(rng, 2, 3, 37, 16, grad=with_lse)
    opcheck(cuda_attention.attention_fwd_op, (q, k, v, _mask(kind, 2, 37, rng), 0.25, with_lse))


@pytest.mark.parametrize("kind", ["none", "partial"])
def test_opcheck_attention_bwd(kind, rng):
    q, k, v = _qkv(rng, 2, 3, 37, 16)
    mask = _mask(kind, 2, 37, rng)
    out, lse = cuda_attention.attention_fwd_op(q, k, v, mask, 0.25, True)
    dout = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    opcheck(cuda_attention.attention_bwd_op, (q, k, v, out, lse, dout, mask, 0.25))


def test_attention_gradient_goes_through_the_bwd_op(rng, monkeypatch):
    """``attention``'s gradient is ``register_autograd``'s backward, which
    calls ``sevit::attention_bwd`` (on the CPU: ``attention_bwd_plain``),
    and equals autograd through the plain version."""
    q, k, v = _qkv(rng, 2, 2, 20, 16, grad=True)
    mask = _mask("partial", 2, 20, rng)
    dout = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    calls = []
    real = cuda_attention.attention_bwd_plain
    monkeypatch.setattr(cuda_attention, "attention_bwd_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = torch.autograd.grad(cuda_attention.attention(q, k, v, scale=0.25, mask=mask),
                              (q, k, v), dout)
    assert calls == [1]
    ref = torch.autograd.grad(cuda_attention.attention_plain(q, k, v, scale=0.25, mask=mask),
                              (q, k, v), dout)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert not hasattr(cuda_attention, "_Attention")


def test_a_gradient_needs_the_log_sum_exp(rng):
    q, k, v = _qkv(rng, 1, 2, 9, 16, grad=True)
    with pytest.raises(RuntimeError, match="with_lse"):
        cuda_attention.attention_fwd_op(q, k, v, None, 0.25, False)


# ---------------------------------------------------------------------------
# fake impls: shapes and dtypes from the arguments alone
# ---------------------------------------------------------------------------


def _fake_matches(op, args):
    real = op(*args)
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        fake = op(*fake_args)
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(t.shape, t.dtype) for t in fake] == [(t.shape, t.dtype) for t in real]


STFT_GRID = [(n_fft, hop, center) for n_fft in (128, 256, 512, 1024, 2048)
             for hop in (n_fft // 4, n_fft // 2) for center in (True, False)]


@pytest.mark.parametrize("n_fft,hop,center", STFT_GRID)
def test_stft_fake_shapes_equal_the_plain_versions(n_fft, hop, center, rng):
    cfg = STFTConfig(n_fft=n_fft, hop_length=hop, win_length=n_fft, center=center)
    x = torch.from_numpy(rng.standard_normal((2, 3 * n_fft + 17)).astype(np.float32))
    _fake_matches(cuda_stft.stft_mag_op, (x, *_cfg_args(cfg)))
    re, im, mag = cuda_stft.stft_mag_plain(x, cfg)
    phase = torch.atan2(im, re)
    for length in (None, x.shape[1], x.shape[1] + 100):
        _fake_matches(cuda_stft.istft_polar_op, (mag, phase, *_cfg_args(cfg), length))


@pytest.mark.parametrize("n", [1, 37, 200])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("kind", ["none", "partial"])
def test_attention_fake_shapes_equal_the_plain_versions(n, d, kind, rng):
    q, k, v = _qkv(rng, 2, 2, n, d)
    mask = _mask(kind, 2, n, rng)
    for with_lse in (True, False):
        _fake_matches(cuda_attention.attention_fwd_op, (q, k, v, mask, d**-0.5, with_lse))
    out, lse = cuda_attention.attention_fwd_op(q, k, v, mask, d**-0.5, True)
    _fake_matches(cuda_attention.attention_bwd_op,
                  (q, k, v, out, lse, torch.ones_like(q), mask, d**-0.5))


# ---------------------------------------------------------------------------
# export on the CPU
# ---------------------------------------------------------------------------


def _plain_calls(program):
    """aten ops that the plain versions would put in the graph in place of
    the kernels' ops (the model itself uses none of them)."""
    plain = ("aten._softmax", "aten.softmax", "aten.matmul", "aten.bmm", "aten.cos",
             "aten.sin.", "aten.logsumexp")
    return sorted({str(n.target) for n in program.graph.nodes
                   if str(n.target).startswith(plain)})


def test_export_a_depth_2_model(tmp_path, rng):
    model = init_weights(HybridViT(**TINY), torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(rng.random((2, 257, 64, 1)).astype(np.float32))
    program = load_program(export_program(tmp_path / "model.pt2", model, (x,)))
    assert kernels.op_calls(program) == {"attention_fwd": 2}
    assert _plain_calls(program) == []
    kernels.reset_launch_counts()
    with torch.no_grad():
        want = model(x)
        got = program.module()(x)
    assert kernels.launched() == {}  # CPU: the plain versions
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL_EXPORT)


def _pair(io_dtype):
    cfg = read_meta(FIXTURE)["config"]
    jm = JHybridViT(**TINY)
    template = jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a, train=False),
                              jnp.zeros((1, 257, 64, 1), jnp.float32))
    jv = j_load_model_weights(FIXTURE, template)
    tm = load_model_weights(FIXTURE, HybridViT(**TINY))
    kw = dict(io_dtype=io_dtype, mask_padding=True, buckets=(128,))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return JAudioEnhancer(jm, jv, cfg, **kw), AudioEnhancer(tm, cfg, device="cpu", **kw)


def _batch(io_dtype, wav_len, rng):
    lengths = np.array([wav_len, wav_len - 3000, 9000], np.int32)
    t = np.arange(wav_len) / SR
    rows = []
    for n in lengths:
        clean = 0.4 * np.sin(2 * np.pi * rng.uniform(150, 300) * t)
        row = (clean + 0.1 * rng.standard_normal(wav_len)).astype(np.float32)
        row[n:] = 0.0
        rows.append(row)
    noisy = np.stack(rows)
    if io_dtype == "int16":
        noisy = np.clip(np.rint(noisy * 32767.0), -32768, 32767).astype(np.int16)
    return noisy, lengths


@pytest.mark.parametrize("io_dtype", ["float32", "int16"])
def test_export_the_enhancer_core_and_hold_it_to_jax(io_dtype, tmp_path, rng):
    je, te = _pair(io_dtype)
    wav_len = (128 - 1) * te.stft_cfg.hop_length
    noisy, lengths = _batch(io_dtype, wav_len, rng)
    core = EnhancerCore(te)
    assert core.model is te.model
    args = (torch.from_numpy(noisy), torch.from_numpy(lengths))
    program = load_program(export_program(tmp_path / "core.pt2", core, args))
    assert kernels.op_calls(program) == {"stft_mag": 1, "attention_fwd": TINY["num_layers"],
                                         "istft_polar": 1}
    assert _plain_calls(program) == []
    with torch.no_grad():
        eager = core(*args).numpy()
        got = program.module()(*args).numpy()
    assert got.dtype == (np.int16 if io_dtype == "int16" else np.float32)
    assert got.shape == noisy.shape
    ref = np.asarray(je._core(wav_len)(je.variables, jnp.asarray(noisy), jnp.asarray(lengths)))
    if io_dtype == "int16":
        assert np.abs(got.astype(np.int32) - eager.astype(np.int32)).max() == 0
        assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(got, eager, rtol=0, atol=ATOL_EXPORT)
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
