"""A numpy model of the arithmetic of kernel K2, on the CPU.

The CUDA kernel (``csrc/attention.cu``) runs only on a card. This file
repeats its arithmetic step by step in float32 numpy: the 3xTF32 split
(``cvt.rna.tf32.f32`` as bit operations), the chain of m16n8k8 products per
8-deep k-step with fp32 accumulation, the tiles of keys with the online
softmax in base 2 in the kernel's order (running max, per-thread partial
sums of columns 2t and 2t + 1, rescale once per tile, the four partial
sums met at the end), the -1e30 logit of a masked key and the -inf of a
position past the last key, and the gather of a masked row's kept keys. The
model is held against JAX ``fused_attention`` and ``sdpa_reference`` and the
port's plain version. Change one, change the other.

Tolerance 2e-5 absolute, as for the kernel on the card: 3xTF32 keeps each
product to ~2^-21 of its size, so the outputs stay ~1e-6 from fp32. One
TF32 pass (~2^-11 per operand) misses it, which the last test shows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.models.attention import (
    sdpa_reference,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.ops.pallas_attention import (
    fused_attention,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models.components import (
    patch_validity_mask,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.cuda_attention import (
    LOG2E,
    attention,
)

ATOL = 2e-5
F32 = np.float32
MASKED = F32(-1e30)


@pytest.fixture(autouse=True)
def _two_threads():
    torch.set_num_threads(2)


def tile_keys(d):
    """Keys per K/V tile (``tile_keys<D>``)."""
    return 64 if d <= 64 else 32


def tf32_rna(x):
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, to
    nearest with ties away from zero, the 13 low bits cleared."""
    bits = np.ascontiguousarray(x, dtype=F32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def split(x):
    """x = hi + lo, both TF32: hi rounds x, lo rounds what hi leaves."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mma_chain(acc, a, b, passes=3):
    """``acc [..., M, N] + a [..., M, K] @ b [..., K, N]`` as the kernel's
    chain of m16n8k8 products: per 8-deep k-step a_lo b_hi, a_hi b_lo, then
    a_hi b_hi (one pass: a_hi b_hi alone). A product of two TF32 values is
    exact in fp32; each is added to the fp32 accumulator in turn."""
    (ah, al), (bh, bl) = split(a), split(b)
    terms = ((al, bh), (ah, bl), (ah, bh))[3 - passes:]
    for k0 in range(0, a.shape[-1], 8):
        for x, y in terms:
            for kk in range(k0, k0 + 8):
                acc = acc + x[..., :, kk, None] * y[..., None, kk, :]
    assert acc.dtype == F32
    return acc


def model_attention(q, k, v, scale, mask=None, gather=True, passes=3):
    """K2 on ``[B, H, N, D]`` float32 arrays, ``mask [B, N]`` bool.
    ``gather=False`` is not the kernel: it scores every key of a masked row,
    the masked ones at -1e30, where the kernel leaves them out."""
    b, h, n, d = q.shape
    bk = tile_keys(d)
    qs = q * F32(scale * LOG2E)  # the wrapper hands scale * log2(e) as a C float
    out = np.empty_like(q)
    for bi in range(b):
        # the keys the blocks of this batch row walk
        keys, masked = np.arange(n), None  # masked: the keys whose logit is -1e30
        if mask is not None:
            if gather and mask[bi].any():
                keys = np.flatnonzero(mask[bi])
            else:  # a row that keeps no key walks all n, each at -1e30
                masked = ~mask[bi]
        count = len(keys)
        m = np.full((h, n, 1), -np.inf, F32)
        l4 = np.zeros((h, n, 4), F32)  # partial sums of threads t = 0..3
        o = np.zeros((h, n, d), F32)
        for j0 in range(0, count, bk):
            pos = j0 + np.arange(bk)
            present = pos < count
            idx = keys[np.minimum(pos, count - 1)]
            kt = np.where(present[:, None], k[bi][:, idx], F32(0))  # rows past the end zero filled
            vt = np.where(present[:, None], v[bi][:, idx], F32(0))
            s = mma_chain(np.zeros((h, n, bk), F32), qs[bi], kt.swapaxes(-1, -2), passes)
            if masked is not None:
                s[..., present & masked[idx]] = MASKED
            s[..., ~present] = -np.inf
            m_new = np.maximum(m, s.max(axis=-1, keepdims=True))
            corr = np.exp2(m - m_new)
            p = np.exp2(s - m_new)
            l4 = l4 * corr
            for nt in range(bk // 8):
                for c in range(2):
                    l4 = l4 + p[..., nt * 8 + 2 * np.arange(4) + c]
            o = mma_chain(o * corr, p, vt, passes)
            m = m_new
        l = (l4[..., 0] + l4[..., 1]) + (l4[..., 2] + l4[..., 3])
        out[bi] = o * (F32(1) / l)[..., None]
    assert out.dtype == F32
    return out


def _mask(kind, b, n, rng):
    """``[b, n]`` bool key mask. "fully_masked_row": row 1 keeps no key;
    "single_key": row 1 keeps one; "patch": ``patch_validity_mask``'s shape,
    16 patch rows whose trailing columns are masked (an interleaved
    stand-in where n is not 16 columns' multiple)."""
    if kind == "none":
        return None
    if kind == "patch":
        if n % 16 == 0:
            lengths = torch.tensor([16000 + 9000 * i for i in range(b)])
            return patch_validity_mask(lengths, 257, n, 128).numpy()
        w = n // 8 if n % 8 == 0 else n
        return (np.arange(n) % w)[None, :] < np.linspace(w // 3, w - 1, b).astype(int)[:, None]
    mask = rng.random((b, n)) > 0.3
    mask[1] = False
    if kind == "single_key":
        mask[1, n // 2] = True
    return mask


def _refs(q, k, v, scale, mask):
    jmask = None if mask is None else jnp.asarray(mask)
    args = [jnp.asarray(x) for x in (q, k, v)]
    return (np.asarray(sdpa_reference(*args, scale, mask=jmask)),
            np.asarray(fused_attention(*args, scale=scale, mask=jmask)))


@pytest.mark.parametrize("n", [37, 200, 384])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("kind", ["none", "fully_masked_row", "single_key", "patch"])
def test_model_matches_jax_and_plain(n, d, kind, rng):
    b, h = 2, 2
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(F32) for _ in range(3))
    mask = _mask(kind, b, n, rng)
    scale = d**-0.5
    got = model_attention(q, k, v, scale, mask)
    sdpa, fused = _refs(q, k, v, scale, mask)
    plain = attention(*map(torch.from_numpy, (q, k, v)), scale=scale,
                      mask=None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, sdpa, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, plain, atol=ATOL, rtol=0)
    if kind != "fully_masked_row":
        # fused_attention averages a fully masked row over its padded length
        # (ROADMAP section 3); every other row agrees
        np.testing.assert_allclose(got, fused, atol=ATOL, rtol=0)
    else:
        np.testing.assert_allclose(got[0], fused[0], atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", [65, 384])
@pytest.mark.parametrize("kind", ["fully_masked_row", "single_key", "patch"])
def test_gathering_kept_keys_changes_nothing(n, kind, rng):
    """Leaving a masked row's masked keys out (the kernel) or scoring them
    at -1e30 (``sdpa_reference``'s rule): the same result, within the
    tolerance of either against the reference."""
    b, h, d = 2, 2, 16
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(F32) for _ in range(3))
    mask = _mask(kind, b, n, rng)
    gathered = model_attention(q, k, v, d**-0.5, mask, gather=True)
    dense = model_attention(q, k, v, d**-0.5, mask, gather=False)
    sdpa, _ = _refs(q, k, v, d**-0.5, mask)
    np.testing.assert_allclose(gathered, dense, atol=ATOL, rtol=0)
    np.testing.assert_allclose(dense, sdpa, atol=ATOL, rtol=0)


def test_one_tf32_pass_misses_the_tolerance(rng):
    b, h, n, d = 2, 2, 200, 64
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(F32) for _ in range(3))
    mask = _mask("patch", b, n, rng)
    sdpa, _ = _refs(q, k, v, d**-0.5, mask)
    err3 = np.abs(model_attention(q, k, v, d**-0.5, mask, passes=3) - sdpa).max()
    err1 = np.abs(model_attention(q, k, v, d**-0.5, mask, passes=1) - sdpa).max()
    assert err3 < ATOL < err1


def test_tf32_rna_rounding():
    ulp = 2.0**-10  # of a TF32 value in [1, 2)
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0**-23, 1 + 1.5 * ulp, 3.0], F32)
    np.testing.assert_array_equal(tf32_rna(x), np.array([1 + ulp, -(1 + ulp), 1, 1 + 2 * ulp, 3], F32))
    r = np.random.default_rng(1).standard_normal(10000).astype(F32) * F32(100)
    hi, lo = split(r)
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    assert (np.abs(r - hi) <= 2.0**-11 * np.abs(r)).all()
    assert (np.abs(r - (hi + lo)) <= 2.0**-22 * np.abs(r)).all()
