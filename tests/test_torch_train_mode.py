"""The port's train-mode building blocks against the JAX package's on the
CPU.

BatchNorm in train mode as flax computes it: the batch mean and the biased
variance normalize, and the running statistics move by 0.1 towards them
(torch's own ``BatchNorm2d`` would keep the unbiased variance, n/(n-1) off).
A ``ConvBlock`` and a ``TransposeConvBlock`` in train mode (dropout 0) give
the JAX block's output and new ``batch_stats`` within 1e-5 (float32). A
compute dtype other than float32 and bfloat16, and an attention type other
than standard and linear, raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.models.components import (
    ConvBlock as JConvBlock,
    TransposeConvBlock as JTransposeConvBlock,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import HybridViT
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models.components import (
    BatchNorm,
    ConvBlock,
    TransposeConvBlock,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
    flax_to_state_dict,
)

torch.set_num_threads(2)


def _load(block, variables, prefix):
    """The flax block's variables into the port block (``prefix`` is the
    port name the block would have in a HybridViT)."""
    sd = flax_to_state_dict({k: {prefix: v} for k, v in variables.items()})
    res = block.load_state_dict({k[len(prefix) + 1:]: v for k, v in sd.items()}, strict=False)
    assert not res.unexpected_keys
    assert all(k.endswith("num_batches_tracked") for k in res.missing_keys)


@pytest.mark.parametrize("kind", ["conv", "transpose"])
def test_train_mode_block_matches_flax(kind, rng):
    x = (rng.standard_normal((3, 12, 10, 5)) * 2 + 0.7).astype(np.float32)  # NHWC
    if kind == "conv":
        jb, tb, prefix = JConvBlock(8, pool_size=2), ConvBlock(5, 8, pool_size=2), "encoder_0"
    else:
        jb, tb, prefix = (JTransposeConvBlock(8, upsample_factor=2),
                          TransposeConvBlock(5, 8, upsample_factor=2), "decoder_0")
    variables = jax.tree_util.tree_map(np.asarray, jb.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape)).astype(np.float32), variables["batch_stats"])
    variables["params"] = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.3 + (1.0 if a.ndim == 1 else 0.0)
                   ).astype(np.float32), variables["params"])
    out, mutated = jb.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    _load(tb, variables, prefix)
    tb.train()
    got = tb(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5, rtol=1e-5)
    stats = mutated["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(tb.bn.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-5)
    np.testing.assert_allclose(tb.bn.running_var.numpy(), np.asarray(stats["var"]), atol=1e-5)


def test_batchnorm_uses_the_biased_variance():
    bn = BatchNorm(1).train()
    x = torch.tensor([1.0, 2.0, 3.0, 6.0]).reshape(4, 1, 1, 1)
    y = bn(x)
    var = float(x.var(unbiased=False))  # 3.5; unbiased 14/3
    assert bn.running_var.item() == pytest.approx(0.9 + 0.1 * var)
    assert bn.running_mean.item() == pytest.approx(0.1 * 3.0)
    torch.testing.assert_close(y.flatten(), (x.flatten() - 3.0) / np.sqrt(var + 1e-5))
    bn.eval()
    torch.testing.assert_close(bn(x).flatten(), (x.flatten() - bn.running_mean)
                               / torch.sqrt(bn.running_var + 1e-5))


def test_unported_options_raise():
    with pytest.raises(ValueError, match="compute_dtype"):
        HybridViT(compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="attention_type"):
        HybridViT(attention_type="performer")


def test_drop_path_rates_rise_linearly():
    model = HybridViT(embed_dim=32, num_heads=2, num_layers=4, encoder_channels=(4, 8, 16),
                      decoder_channels=(8, 4, 4, 1), drop_path_rate=0.3)
    rates = [b.drop_path.drop_prob for b in model.transformer.blocks]
    np.testing.assert_allclose(rates, np.linspace(0, 0.3, 4))
