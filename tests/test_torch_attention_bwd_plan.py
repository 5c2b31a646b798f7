"""A numpy model of the algorithm of K2's backward, on the CPU.

The CUDA kernel (``csrc/attention_bwd.cu``) runs only on a card. This file
repeats its passes in float32 numpy: each row's log-sum-exp as the forward
writes it (m + log2 l over the keys the row walks, in log2 units), Delta =
rowsum(dO * O), the dq pass over 64-row query blocks and 64-key tiles of the
walked keys, the dk/dv pass over 64-key blocks of the walked keys and
64-row query tiles, the weights recomputed as exp2(Q K^T scale log2(e) -
lse), the kept-key list of a masked row, the zero rows its blocks write for
the masked keys among their positions, and the closed form of a row that
keeps no key (dq = dk = 0, dv the mean of dO). Every element of dq, dk and
dv must be written. The model is held against autograd through the port's
plain version and ``jax.vjp`` of ``sdpa_reference`` at several N and D,
a fully masked row and a one-key row included. Change one, change the
other.

Tolerance: 2e-5 of each gradient's largest magnitude, or of 1 where that
is smaller (float32 sums in another order; the weights from the
log-sum-exp rather than a two-pass softmax; at N = 1 the true dq and dk are
0 and both sides hold rounding residue).
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
from test_torch_attention_plan import _mask

torch.set_num_threads(2)

F32 = np.float32
T = 64  # query rows and keys per tile, both passes
TOL = 2e-5


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


def model_attention_bwd(q, k, v, out, dout, scale, mask=None):
    """K2's backward on ``[B, H, N, D]`` float32 arrays: ``(dq, dk, dv)``."""
    b, h, n, d = q.shape
    qscale = F32(scale * LOG2E)
    dq, dk, dv = (np.full_like(q, np.nan) for _ in range(3))
    for bi in range(b):
        mrow = None if mask is None else mask[bi]
        keys, all_masked = walked_keys(mrow, n)
        count = len(keys)
        qb, kb, vb, dob = q[bi], k[bi], v[bi], dout[bi]
        lse = model_lse(qb, kb, qscale, keys, all_masked)
        delta = (dob * out[bi]).sum(axis=-1)  # [H, N], the dq pass writes it
        # dq pass: a block per 64 query rows, over the walked keys in tiles
        for i0 in range(0, n, T):
            rows = np.arange(i0, min(i0 + T, n))
            acc = np.zeros((h, len(rows), d), F32)
            if not all_masked:  # every dS of a row that keeps no key is 0
                for j0 in range(0, count, T):
                    idx = keys[j0:j0 + T]
                    s = np.einsum("hnd,hmd->hnm", qb[:, rows], kb[:, idx])
                    dp = np.einsum("hnd,hmd->hnm", dob[:, rows], vb[:, idx])
                    p = np.exp2(s * qscale - lse[:, rows, None])
                    ds = p * (dp - delta[:, rows, None])
                    acc = acc + np.einsum("hnm,hmd->hnd", ds, kb[:, idx])
            dq[bi][:, rows] = acc * F32(scale)
        # dk/dv pass: a block per 64 positions of the walked keys
        for j0 in range(0, n, T):
            pos = np.arange(j0, min(j0 + T, n))
            if all_masked:  # P = 1/N, dS = 0
                dk[bi][:, pos] = 0.0
                dv[bi][:, pos] = (dob.sum(axis=1) / F32(n))[:, None, :]
                continue
            if mrow is not None:  # the masked keys among the block's positions
                dropped = pos[~mrow[pos]]
                dk[bi][:, dropped] = 0.0
                dv[bi][:, dropped] = 0.0
            if j0 >= count:
                continue
            idx = keys[j0:j0 + T]
            dka = np.zeros((h, len(idx), d), F32)
            dva = np.zeros((h, len(idx), d), F32)
            for i0 in range(0, n, T):
                rows = np.arange(i0, min(i0 + T, n))
                s = np.einsum("hmd,hnd->hmn", kb[:, idx], qb[:, rows])
                dp = np.einsum("hmd,hnd->hmn", vb[:, idx], dob[:, rows])
                p = np.exp2(s * qscale - lse[:, None, rows])
                ds = p * (dp - delta[:, None, rows])
                dva = dva + np.einsum("hmn,hnd->hmd", p, dob[:, rows])
                dka = dka + np.einsum("hmn,hnd->hmd", ds, qb[:, rows])
            dk[bi][:, idx] = dka * F32(scale)
            dv[bi][:, idx] = dva
    for g in (dq, dk, dv):
        assert g.dtype == F32 and not np.isnan(g).any()  # every element written
    return dq, dk, dv


def _rel(got, ref):
    return max(float(np.abs(a - r).max() / max(np.abs(r).max(), 1.0)) for a, r in zip(got, ref))


CASES = [(1, "none")] + [(n, kind) for n in (37, 65, 200)
                         for kind in ("none", "fully_masked_row", "single_key", "patch")]


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("n,kind", CASES)
def test_model_matches_plain_and_jax(n, kind, d, rng):
    q, k, v, dout = (rng.standard_normal((2, 3, n, d)).astype(F32) for _ in range(4))
    mask = _mask(kind, 2, n, rng)
    scale = d**-0.5
    tmask = None if mask is None else torch.from_numpy(mask)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = attention_plain(tq, tk, tv, scale=scale, mask=tmask).numpy()
    got = model_attention_bwd(q, k, v, out, dout, scale, mask)
    plain = [g.numpy() for g in attention_bwd_plain(tq, tk, tv, torch.from_numpy(dout),
                                                    scale=scale, mask=tmask)]
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
    ``patch_validity_mask``: 6 key tiles, several kept-key blocks empty."""
    n, d = 384, 64
    q, k, v, dout = (rng.standard_normal((2, 1, n, d)).astype(F32) for _ in range(4))
    mask = _mask("patch", 2, n, rng)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = attention_plain(tq, tk, tv, scale=d**-0.5, mask=torch.from_numpy(mask)).numpy()
    got = model_attention_bwd(q, k, v, out, dout, d**-0.5, mask)
    plain = [g.numpy() for g in attention_bwd_plain(tq, tk, tv, torch.from_numpy(dout),
                                                    scale=d**-0.5, mask=torch.from_numpy(mask))]
    assert _rel(got, plain) <= TOL
