"""The port's linear attention (JAX ``EfficientAttention`` and the linear
branch of ``VisionTransformer``) against the JAX package's on the CPU.

The forward holds the model-output tolerance of ``test_torch_model.py``
(1e-4 absolute), one train step the limits of ``test_torch_train_step.py``.
The JAX branch ignores the key mask and has no drop-path; so does the port.
Its weights cross in both directions under the JAX names (``lin_attn_i``,
``lin_mlp_i``, ``lin_norm1_i``, ``lin_norm2_i``), exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.models import HybridViT as JHybridViT
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.models.attention import (
    EfficientAttention as JEfficientAttention,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
    HybridViT,
    create_hybrid_vit,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models.attention import (
    EfficientAttention,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from test_torch_model import ATOL, SMALL, _forward, _jax_forward, _jax_variables
from test_torch_train_step import check_train_step

torch.set_num_threads(2)

LINEAR = dict(SMALL, attention_type="linear")


def test_efficient_attention_matches_jax(rng):
    x = rng.standard_normal((2, 37, 64)).astype(np.float32)
    jm = JEfficientAttention(64, num_heads=4)
    v = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.2,
        jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a), jnp.asarray(x)))
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = EfficientAttention(64, num_heads=4).eval()
    tm.load_state_dict({"qkv.weight": torch.tensor(v["params"]["Dense_0"]["kernel"].T),
                        "qkv.bias": torch.tensor(v["params"]["Dense_0"]["bias"]),
                        "proj.weight": torch.tensor(v["params"]["Dense_1"]["kernel"].T),
                        "proj.bias": torch.tensor(v["params"]["Dense_1"]["bias"])})
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("head", ["resize", "fullres_mask"])
def test_linear_forward_matches_jax_and_ignores_the_mask(head, rng):
    x = rng.random((2, 257, 64, 1)).astype(np.float32)
    kw = dict(LINEAR, head_type=head, head_channels=8)
    jm = JHybridViT(**kw)
    v = _jax_variables(jm, x, rng)
    ref = _jax_forward(jm, v, x)
    tm = HybridViT(**kw).eval()
    tm.load_state_dict(flax_to_state_dict(v), strict=True)
    out = _forward(tm, x)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    mask = np.ones((2, 16 * 4), bool)
    mask[1, 5:] = False
    np.testing.assert_array_equal(_forward(tm, x, mask), out)


def test_linear_weights_cross_both_ways(rng):
    x = rng.random((1, 257, 32, 1)).astype(np.float32)
    v = _jax_variables(JHybridViT(**LINEAR), x, rng)
    sd = flax_to_state_dict(v)
    assert any(k.startswith("transformer.lin_attn_1.qkv.") for k in sd)
    model = HybridViT(**LINEAR)
    model.load_state_dict(sd, strict=True)
    back = state_dict_to_flax(model.state_dict())
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(a)  # noqa: E731
                      for p, a in jax.tree_util.tree_leaves_with_path(t)}
    want, got = flat(v), flat(back)
    assert set(got) == set(want)
    for k in want:  # (the drawn kernels are float64; the model holds float32)
        np.testing.assert_array_equal(got[k], want[k].astype(np.float32), err_msg=k)


def test_create_hybrid_vit_reads_attention_type():
    model = create_hybrid_vit({"model": {"transformer": {
        "attention_type": "linear", "embed_dim": 32, "num_heads": 2, "num_layers": 2}}})
    assert model.transformer.linear and hasattr(model.transformer, "lin_mlp_1")
    assert not hasattr(model.transformer, "blocks")


def test_linear_train_step_matches_jax(rng):
    check_train_step("resize", "mask", True, "learned_1d", False, True, rng,
                     jax_kw=dict(attention_type="linear"), port_kw=dict(attention_type="linear"))
