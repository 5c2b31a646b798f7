"""A numpy model of the arithmetic of K2's backward, on the CPU.

The CUDA kernel (``csrc/attention_bwd.cu``) runs only on a card. This file
repeats its two passes in float32 numpy, with the forward's 3xTF32 products
(``split`` and ``mma_chain`` of ``test_torch_attention_plan.py``: per 8-deep
k-step a_lo b_hi, a_hi b_lo, a_hi b_hi into an fp32 accumulator) in the
kernel's k order: a product over the head dim takes its columns in
``kcol``'s order, a product over keys or queries (the weights as the A
operand) takes each 8-wide step's columns as 0,2,4,6,1,3,5,7. Each row's
log-sum-exp is the forward's (m + log2 l over the keys the row walks, log2
units); Delta = rowsum(dO * O) in the kernel's order (a thread's columns,
then its quad).

- dq pass: the rows' Q (times scale * log2(e)) and dO against the walked
  keys in tiles of 32, K and V rows past the last walked key zero: S = Q
  K^T, dP = dO V^T, P = exp2(S - lse) and 0 past the last key, dS = P (dP -
  Delta), dq += dS K; dq * scale.
- dk/dv pass: the walked keys' K (times scale * log2(e)) and V against all
  query rows in tiles of 32 (16 at D = 128), with the lse and Delta of each
  column: S^T = K Q^T, dP^T = V dO^T, P^T = exp2(S^T - lse) and 0 past the
  last row, dS^T = P^T (dP^T - Delta), dv += P^T dO, dk += dS^T Q; dk *
  scale. The zero rows of the masked keys, written by the blocks of 64 key
  positions, and the closed form of a row that keeps no key (dq = dk = 0,
  dv the mean of dO).

Rows are independent in both passes (a warp's 16 rows, a block's 64, do the
same arithmetic; the kernel keeps the A operands split in shared memory,
which changes no value), so each pass takes all of a head's rows at once;
the tiles it walks are the kernel's. Every element of dq, dk and dv must be
written. The model is held against autograd through the port's plain
version and ``jax.vjp`` of ``sdpa_reference`` at several N and D, a fully
masked row and a one-key row included. Change one, change the other.

Tolerance: 2e-5 of each gradient's largest magnitude, or of 1 where that
is smaller (3xTF32 keeps each product to ~2^-21 of its size; float32 sums
in another order; the weights from the log-sum-exp rather than a two-pass
softmax; at N = 1 the true dq and dk are 0 and both sides hold rounding
residue). One TF32 pass misses it, which a test shows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.models.attention import (
    sdpa_reference,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.cuda_attention import (
    LOG2E,
    attention_bwd_plain,
    attention_plain,
)
from test_torch_attention_plan import _mask, mma_chain

torch.set_num_threads(2)

F32 = np.float32
BM = 64  # query rows (dq pass) or key positions (dk/dv pass) per block
BK = 32  # keys per K/V tile of the dq pass
TOL = 2e-5
STEP8 = np.array([0, 2, 4, 6, 1, 3, 5, 7])  # an accumulator tile's columns as A's k-step


def dkdv_tile(d):
    """Query rows per Q/dO tile of the dk/dv pass (``dkdv_tile<D>``)."""
    return 32 if d <= 64 else 16


def kcol(d, kk, t):
    """The first of the two head-dim columns thread t takes at k-step kk
    (``kcol<D>``): in chunks of 32 columns, pairs at 2 (t & 1) + 16 (t >> 1)
    + 4 (kk & 3); the forward's 8 kk + 2 t at D = 16."""
    if d >= 32:
        return (kk >> 2) * 32 + (kk & 3) * 4 + (t & 1) * 2 + (t >> 1) * 16
    return kk * 8 + 2 * t


def head_order(d):
    """The head-dim columns in the order the kernel's k-steps take them: per
    k-step, A's columns t = 0..3 (``kcol``) then t + 4 (the next column)."""
    order = []
    for kk in range(d // 8):
        first = [kcol(d, kk, t) for t in range(4)]
        order += first + [c + 1 for c in first]
    return np.array(order)


def mma_head(a, b, d, passes):
    """``a [..., M, D] @ b [..., N, D]^T`` over the head dim, in kcol's
    order."""
    o = head_order(d)
    acc = np.zeros(a.shape[:-1] + (b.shape[-2],), F32)
    return mma_chain(acc, a[..., o], b[..., o].swapaxes(-1, -2), passes)


def mma_weights(acc, w, b, passes):
    """``acc + w [..., M, T] @ b [..., T, D]``, the weights' columns as A
    fragments: each 8-wide k-step in the order 0,2,4,6,1,3,5,7."""
    o = (np.arange(w.shape[-1] // 8)[:, None] * 8 + STEP8).ravel()
    return mma_chain(acc, w[..., o], b[..., o, :], passes)


def walked_keys(mask_row, n):
    """(keys, all_masked): the keys a batch row's blocks walk."""
    if mask_row is None:
        return np.arange(n), False
    if mask_row.any():
        return np.flatnonzero(mask_row), False
    return np.arange(n), True


def model_lse(q, k, qscale, keys, all_masked):
    """``[H, N]`` log-sum-exp in log2 units over the walked keys, as the
    forward kernel writes it (a row that keeps none: every logit -1e30)."""
    s = np.einsum("hnd,hmd->hnm", q * qscale, k[:, keys])
    if all_masked:
        s[:] = F32(-1e30)
    m = s.max(axis=-1)
    return (m + np.log2(np.exp2(s - m[..., None]).sum(axis=-1))).astype(F32)


def model_delta(dout, out):
    """``[H, N]`` rowsum(dO * O): each thread t of a quad sums its columns
    (kcol's pairs, k-step by k-step, the second column first), then the quad
    adds (t0 + t1) + (t2 + t3)."""
    d = dout.shape[-1]
    prod = dout * out
    part = np.zeros(dout.shape[:-1] + (4,), F32)
    for kk in range(d // 8):
        for t in range(4):
            c = kcol(d, kk, t)
            part[..., t] = part[..., t] + prod[..., c + 1] + prod[..., c]
    return (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])


def tile(x, index, r0, size):
    """Rows ``index[r0:r0 + size]`` of ``x [H, *, ...]`` and which are
    present: positions past the end of ``index`` are zero filled (the
    tile's rows past the last walked key or query row)."""
    pos = r0 + np.arange(size)
    present = pos < len(index)
    got = x[:, index[np.minimum(pos, len(index) - 1)]]
    return np.where(present.reshape((-1,) + (1,) * (x.ndim - 2)), got, F32(0)), present


def model_attention_bwd(q, k, v, out, dout, scale, mask=None, passes=3):
    """K2's backward on ``[B, H, N, D]`` float32 arrays: ``(dq, dk, dv)``.
    ``passes=1``: each product in one TF32 pass (a_hi b_hi), not the
    kernel."""
    b, h, n, d = q.shape
    qscale = F32(scale * LOG2E)  # the wrapper hands scale * log2(e) as a C float
    bq = dkdv_tile(d)
    dq, dk, dv = (np.full_like(q, np.nan) for _ in range(3))
    for bi in range(b):
        mrow = None if mask is None else mask[bi]
        keys, all_masked = walked_keys(mrow, n)
        count = len(keys)
        qb, kb, vb, dob = q[bi], k[bi], v[bi], dout[bi]
        lse = model_lse(qb, kb, qscale, keys, all_masked)
        delta = model_delta(dob, out[bi])  # [H, N], the dq pass writes it

        # dq pass: every query row against the walked keys, tile by tile
        qs = qb * qscale
        acc = np.zeros((h, n, d), F32)
        if not all_masked:  # every dS of a row that keeps no key is 0
            for j0 in range(0, count, BK):
                kt, present = tile(kb, keys, j0, BK)  # [H, BK, D]
                vt, _ = tile(vb, keys, j0, BK)
                s = mma_head(qs, kt, d, passes)
                dp = mma_head(dob, vt, d, passes)
                p = np.exp2(s - lse[..., None])
                p[..., ~present] = 0.0
                ds = p * (dp - delta[..., None])
                acc = mma_weights(acc, ds, kt, passes)
        dq[bi] = acc * F32(scale)

        # dk/dv pass: the blocks of 64 key positions
        for j0 in range(0, n, BM):
            pos = np.arange(j0, min(j0 + BM, n))
            if all_masked:  # P = 1/N, dS = 0
                dk[bi][:, pos] = 0.0
                dv[bi][:, pos] = (dob.sum(axis=1) / F32(n))[:, None, :]
            elif mrow is not None:  # the masked keys among the block's positions
                dropped = pos[~mrow[pos]]
                dk[bi][:, dropped] = 0.0
                dv[bi][:, dropped] = 0.0
        if all_masked:
            continue
        # every walked key against all query rows, tile by tile
        kf, vf = kb[:, keys] * qscale, vb[:, keys]
        dka = np.zeros((h, count, d), F32)
        dva = np.zeros((h, count, d), F32)
        for i0 in range(0, n, bq):
            qt, present = tile(qb, np.arange(n), i0, bq)  # [H, BQ, D]
            dot, _ = tile(dob, np.arange(n), i0, bq)
            lt, _ = tile(lse, np.arange(n), i0, bq)  # [H, BQ]
            dlt, _ = tile(delta, np.arange(n), i0, bq)
            st = mma_head(kf, qt, d, passes)  # [H, keys, BQ]
            dpt = mma_head(vf, dot, d, passes)
            pt = np.exp2(st - lt[:, None, :])
            pt[..., ~present] = 0.0
            dst = pt * (dpt - dlt[:, None, :])
            dva = mma_weights(dva, pt, dot, passes)
            dka = mma_weights(dka, dst, qt, passes)
        dk[bi][:, keys] = dka * F32(scale)
        dv[bi][:, keys] = dva
    for g in (dq, dk, dv):
        assert g.dtype == F32 and not np.isnan(g).any()  # every element written
    return dq, dk, dv


def _rel(got, ref):
    return max(float(np.abs(a - r).max() / max(np.abs(r).max(), 1.0)) for a, r in zip(got, ref))


def _plain(q, k, v, dout, scale, mask):
    tmask = None if mask is None else torch.from_numpy(mask)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = attention_plain(tq, tk, tv, scale=scale, mask=tmask).numpy()
    grads = attention_bwd_plain(tq, tk, tv, torch.from_numpy(dout), scale=scale, mask=tmask)
    return out, [g.numpy() for g in grads]


CASES = [(1, "none")] + [(n, kind) for n in (37, 65, 200)
                         for kind in ("none", "fully_masked_row", "single_key", "patch")]


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("n,kind", CASES)
def test_model_matches_plain_and_jax(n, kind, d, rng):
    q, k, v, dout = (rng.standard_normal((2, 3, n, d)).astype(F32) for _ in range(4))
    mask = _mask(kind, 2, n, rng)
    scale = d**-0.5
    out, plain = _plain(q, k, v, dout, scale, mask)
    got = model_attention_bwd(q, k, v, out, dout, scale, mask)
    assert _rel(got, plain) <= TOL
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda *a: sdpa_reference(*a, scale, mask=jmask),
                     *(jnp.asarray(x) for x in (q, k, v)))
    assert _rel(got, [np.asarray(g) for g in vjp(jnp.asarray(dout))]) <= TOL
    if mask is not None:  # exact zeros at masked keys, as the kernel writes them
        for bi in range(2):
            if mask[bi].any():
                assert not got[1][bi][:, ~mask[bi]].any() and not got[2][bi][:, ~mask[bi]].any()
            else:
                assert not got[0][bi].any() and not got[1][bi].any()


def test_model_at_the_train_shape(rng):
    """One head group at the training path's N = 384, D = 64 under a
    ``patch_validity_mask``: up to 12 key tiles and 12 query tiles, several
    kept-key blocks empty."""
    n, d = 384, 64
    q, k, v, dout = (rng.standard_normal((2, 1, n, d)).astype(F32) for _ in range(4))
    mask = _mask("patch", 2, n, rng)
    out, plain = _plain(q, k, v, dout, d**-0.5, mask)
    got = model_attention_bwd(q, k, v, out, dout, d**-0.5, mask)
    assert _rel(got, plain) <= TOL


def test_one_tf32_pass_misses_the_tolerance(rng):
    n, d = 200, 64
    q, k, v, dout = (rng.standard_normal((2, 2, n, d)).astype(F32) for _ in range(4))
    mask = _mask("patch", 2, n, rng)
    out, plain = _plain(q, k, v, dout, d**-0.5, mask)
    err3 = _rel(model_attention_bwd(q, k, v, out, dout, d**-0.5, mask, passes=3), plain)
    err1 = _rel(model_attention_bwd(q, k, v, out, dout, d**-0.5, mask, passes=1), plain)
    assert err3 < TOL < err1


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_tile_loads_and_their_banks(d):
    """kcol takes every head-dim column once. At the row stride D + 4 of
    every tile, each half-warp's float2 loads (threads g = 0..3 or 4..7, t =
    0..3) touch 32 distinct banks in both patterns a tile is read in: as
    S's B operand (row g, columns kcol(kk, t) + 0, 1) and as the B operand
    of a product by the weights (rows 2t and 2t + 1, columns 16p + 2g + 0,
    1). At D = 16 the first pattern is 2-way conflicted."""
    ld = d + 4
    assert sorted(head_order(d)) == list(range(d))

    def most_per_bank(words):
        return max(np.bincount(np.array(words) % 32))

    for half in (range(0, 4), range(4, 8)):
        for kk in range(d // 8):
            words = [g * ld + kcol(d, kk, t) + c for g in half for t in range(4) for c in (0, 1)]
            assert most_per_bank(words) == (1 if d >= 32 else 2)
        for row in (0, 1):
            for p in range(d // 16):
                words = [(2 * t + row) * ld + 16 * p + 2 * g + c
                         for g in half for t in range(4) for c in (0, 1)]
                assert most_per_bank(words) == 1
