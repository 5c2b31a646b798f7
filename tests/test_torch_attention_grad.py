"""Gradients of the port's attention on the CPU against the JAX package's.

Autograd through the plain version (what ``attention`` runs on a CPU
tensor, and ``attention_bwd_plain``, the plain version of K2's backward)
against ``jax.vjp`` of ``sdpa_reference``, with a fully masked
row and a one-key row among the masks, and against the custom VJP of
``fused_attention`` (``_fused_bwd``) where no row is fully masked: that
path's additive bias gives a fully masked row other weights. Tolerance
1e-5 of each gradient's largest magnitude (float32, another summation
order). Also the model's two attention branches in train mode.
"""

import jax
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
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models.attention import (
    MultiHeadSelfAttention,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.cuda_attention import (
    attention,
    attention_bwd_plain,
)
from test_torch_attention_plan import _mask

torch.set_num_threads(2)

TOL = 1e-5


def _rel(got, ref):
    return max(float(np.abs(np.asarray(a) - np.asarray(r)).max() / max(np.abs(np.asarray(r)).max(), 1e-30))
               for a, r in zip(got, ref))


@pytest.mark.parametrize("n", [37, 64])
@pytest.mark.parametrize("kind", ["none", "patch", "fully_masked_row", "single_key"])
def test_plain_attention_grad_matches_jax(n, kind, rng):
    q, k, v, dout = (rng.standard_normal((2, 3, n, 16)).astype(np.float32) for _ in range(4))
    mask = _mask(kind, 2, n, rng)
    scale = 16**-0.5
    jmask = None if mask is None else jnp.asarray(mask)
    args = [jnp.asarray(x) for x in (q, k, v)]
    _, vjp = jax.vjp(lambda *a: sdpa_reference(*a, scale, mask=jmask), *args)
    ref = vjp(jnp.asarray(dout))

    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    out = attention(*leaves, scale=scale, mask=tmask)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    assert _rel([g.numpy() for g in got], ref) <= TOL
    direct = attention_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                 torch.from_numpy(dout), scale=scale, mask=tmask)
    assert all(torch.equal(a, b) for a, b in zip(direct, got))
    if mask is not None:  # dS is 0 at a masked key: no dk, and no dv unless its row keeps none
        dropped = ~mask[:, None, :, None]
        assert not got[1].numpy()[np.broadcast_to(dropped, got[1].shape)].any()
        keeps = mask.any(axis=1)[:, None, None, None]
        assert not got[2].numpy()[np.broadcast_to(dropped & keeps, got[2].shape)].any()
    if mask is None or mask.any(axis=1).all():
        _, fvjp = jax.vjp(lambda *a: fused_attention(*a, scale=scale, mask=jmask), *args)
        assert _rel([g.numpy() for g in got], fvjp(jnp.asarray(dout))) <= TOL


def test_fully_masked_row_gradients(rng):
    """A row that keeps no key averages V: dq = dk = 0, dv = mean of dO."""
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((1, 2, 9, 16)).astype(np.float32))
                     for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    mask = torch.zeros(1, 9, dtype=torch.bool)
    out = attention(*leaves, scale=0.25, mask=mask)
    dq, dk, dv = torch.autograd.grad(out, leaves, dout)
    assert not dq.any() and not dk.any()
    torch.testing.assert_close(dv, dout.mean(dim=2, keepdim=True).expand_as(dv),
                               rtol=0, atol=1e-6)


def test_attention_branches_in_train_mode(rng):
    """``attn_dropout > 0`` in train mode takes the explicit-weights path
    and drops weights; in eval, or with ``attn_dropout == 0``, the kernel
    path; both agree where no weight is dropped."""
    torch.manual_seed(0)
    x = torch.from_numpy(rng.standard_normal((2, 10, 32)).astype(np.float32))
    attn = MultiHeadSelfAttention(32, 4, attn_dropout=0.5)
    ref = attn.eval()(x)
    attn.attn_dropout = 0.0
    assert torch.allclose(attn.train()(x), ref, atol=1e-6)
    attn.attn_dropout = 0.5
    dropped = attn.train()(x)
    assert not torch.allclose(dropped, ref, atol=1e-3)
    assert torch.allclose(attn.eval()(x), ref)
