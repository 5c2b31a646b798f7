"""``optax_state_to_port`` on optax states the JAX package's optimizer
factory builds, beside the JAX trainer's own checkpoints of
``test_torch_resume_jax.py`` (AdamW in the clip chain, alone and inside
``MultiSteps``): SGD's momentum trace inside the clip chain, and Adam
without a clip (the optimizer's state alone). One update with known
gradients; the port's state holds them within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.models import HybridViT as JHybridViT
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.training.optimizer import (
    chain_with_clip,
    create_optimizer,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import HybridViT
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.optimizer import (
    Optimizer,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
    flax_to_state_dict,
    optax_state_to_port,
)
from test_torch_model import SMALL, _jax_template

torch.set_num_threads(2)


@pytest.mark.parametrize("name,clip", [("sgd", 1.0), ("adam", 0.0)])
def test_optax_state_of_other_optimizers(name, clip, rng):
    """SGD's momentum trace inside the clip chain, and Adam without a clip
    (the optimizer's state alone), read as the port's state."""
    config = {"training": {"optimizer": {"name": name, "lr": 0.05, "momentum": 0.9}}}
    tx = chain_with_clip(create_optimizer(config), clip)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
        _jax_template(JHybridViT(**SMALL), np.zeros((1, 257, 32, 1), np.float32))["params"])
    grads = jax.tree_util.tree_map(lambda a: 0.1 * a, params)
    state = jax.jit(tx.init)(params)
    _, state = jax.jit(tx.update)(grads, state, params)
    names = [n for n, _ in HybridViT(**SMALL).named_parameters()]
    got = optax_state_to_port(serialization.to_state_dict(state), names, name)
    assert got["lr"] == pytest.approx(0.05) and got["count"] == 1 and got["mini_step"] == 0
    want = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)})
    key = "trace" if name == "sgd" else "mu"
    scale = 1.0 if name == "sgd" else 0.1  # the trace of one step is g; Adam's mu is (1 - b1) g
    if name == "sgd" and clip:
        norm = float(optax.global_norm(grads))
        scale = min(1.0, clip / norm)
    for n, t in zip(names, got[key]):
        np.testing.assert_allclose(t.numpy(), scale * want[n].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=n)
    opt = Optimizer([torch.zeros_like(t) for t in got[key]], name, momentum=0.9)
    opt.load_state_dict(got)
    assert opt.count == 1
