"""The port's ``compute_dtype`` against the JAX package's on the CPU.

bf16 in the JAX package rounds the model's input to bf16 once
(``x.astype(compute_dtype)``); flax's convs and dense layers, built without
a ``dtype``, promote that input against their float32 parameters back to
float32, so every layer computes in float32. The port's
``compute_dtype=torch.bfloat16`` does the same: the rounding is
round-to-nearest-even in both frameworks and agrees bit for bit, and the
forward holds the model-output tolerance of ``test_torch_model.py`` (1e-4
absolute).

One train step of each holds the limits of ``test_torch_train_step.py``
(loss 1e-5, gradients 1e-3 of the model's largest and 5e-3 of each leaf's;
the JAX step under ``jax.enable_x64``) with the same model input: the port's
step takes the JAX featurizer's noisy spectrogram. The two featurizers'
float32 spectrograms differ by up to ~5e-7, and bf16 rounding turns such a
difference at a rounding boundary into a one-ulp flip (2^-8 of the value):
measured on this batch, 2 of 49,344 elements, which moves the gradients by
up to 1.4e-2 of a leaf's largest (the float32 step moves them by 1.3e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.data.pipeline import (
    featurize_batch as j_featurize_batch,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.models import HybridViT as JHybridViT
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.ops.stft import STFTConfig as JSTFTConfig
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.pipeline import (
    featurize_batch,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import HybridViT
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import STFTConfig
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
    flax_to_state_dict,
)
from test_torch_model import ATOL, SMALL, _forward, _jax_forward, _jax_variables
from test_torch_train_step import check_train_step, make_batch

torch.set_num_threads(2)


def test_bf16_input_rounding_is_bitwise_equal(rng):
    x = (rng.random((3, 257, 40)) * 10.0 ** rng.uniform(-6, 2, (3, 257, 40))).astype(np.float32)
    ref = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    got = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got - x).max() > 0  # the rounding did something


@pytest.mark.parametrize("head", ["resize", "fullres_mask"])
def test_bf16_forward_matches_jax(head, rng):
    x = rng.random((2, 257, 64, 1)).astype(np.float32)
    kw = dict(SMALL, head_type=head, head_channels=8)
    jm = JHybridViT(**kw, compute_dtype=jnp.bfloat16)
    v = _jax_variables(jm, x, rng)
    ref = _jax_forward(jm, v, x)
    assert ref.dtype == np.float32
    tm = HybridViT(**kw, compute_dtype=torch.bfloat16).eval()
    tm.load_state_dict(flax_to_state_dict(v), strict=True)
    out = _forward(tm, x)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    # and it is not the float32 model's output
    fp32 = HybridViT(**kw).eval()
    fp32.load_state_dict(flax_to_state_dict(v), strict=True)
    assert np.abs(_forward(fp32, x) - out).max() > ATOL


def test_bf16_rounding_flips_where_the_featurizers_differ(rng):
    """Why the train-step test gives both sides one model input: the two
    packages' float32 spectrograms of one batch differ in the last places,
    and bf16 rounding turns such a difference at a rounding boundary into a
    one-ulp flip: at most a few elements (2 of 49,344 measured on one CPU)."""
    batch = make_batch(rng, True)
    with jax.enable_x64(True):
        ref = np.asarray(j_featurize_batch(
            *(jnp.asarray(batch[k]) for k in ("noisy_audio", "clean_audio", "length")),
            JSTFTConfig()).noisy_spec)
    got = featurize_batch(*(torch.from_numpy(batch[k]) for k in ("noisy_audio", "clean_audio",
                                                                 "length")), STFTConfig()).noisy_spec
    assert 0 < np.abs(got.numpy() - ref).max() < 1e-5
    a = got.to(torch.bfloat16).float()
    b = torch.from_numpy(ref).to(torch.bfloat16).float()
    flips = a != b
    assert int(flips.sum()) <= 10 and ref.size == 49344
    # each flip is one bf16 ulp: 2^-7 of the value's power of two
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(a.abs(), b.abs()))) - 7)
    assert torch.equal((a - b).abs()[flips], ulp[flips])


def test_bf16_train_step_matches_jax(rng):
    """The resize head in mask mode with the SI-SDR term, masked, int16
    batch (the fullres head's input skip is in the forward test)."""
    check_train_step("resize", "mask", True, "factored_2d", True, True, rng,
                     jax_kw=dict(compute_dtype=jnp.bfloat16),
                     port_kw=dict(compute_dtype=torch.bfloat16), same_model_input=True)
