"""The port's ``remat`` against the JAX package's on the CPU.

``remat`` recomputes each transformer block in the backward
(``torch.utils.checkpoint``; JAX ``nn.remat``): a port train step with remat
against a JAX one with remat at the limits of ``test_torch_train_step.py``,
and, with dropout, drop-path and attention dropout 0.1, the port's gradients
with remat against its own without, from the same global-generator seed:
within 1e-6 of each leaf's largest (the recompute replays the dropout draws,
so the same arithmetic runs twice).
"""

import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.augmentation import (
    SpecAugmentConfig,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import HybridViT
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import STFTConfig
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.losses import LossConfig
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.trainer import (
    make_step_fns,
)
from test_torch_model import SMALL
from test_torch_train_step import _Capture, check_train_step, make_batch

torch.set_num_threads(2)


def test_remat_train_step_matches_jax(rng):
    check_train_step("resize", "magnitude", False, "learned_1d", False, False, rng,
                     jax_kw=dict(remat=True), port_kw=dict(remat=True))


@pytest.mark.parametrize("attn_dropout", [0.1, 0.0], ids=["explicit_weights", "k2_path"])
def test_remat_gradients_equal_no_remat(attn_dropout, rng):
    kw = dict(SMALL, dropout=0.1, drop_path_rate=0.1, attn_dropout=attn_dropout)
    base = HybridViT(**kw)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(rng, True).items()}
    grads = {}
    for remat in (False, True):
        model = HybridViT(**kw, remat=remat)
        model.load_state_dict(base.state_dict())
        cap = _Capture(list(model.parameters()))
        step, _ = make_step_fns(model, cap, LossConfig(log_l1_weight=0.05), STFTConfig(),
                                SpecAugmentConfig(), augment=False, use_attention_mask=True)
        torch.manual_seed(3)
        metrics = step(batch)
        grads[remat] = (cap.grads, float(metrics["total"]))
    (g0, l0), (g1, l1) = grads[False], grads[True]
    assert l0 == l1
    names = [n for n, _ in base.named_parameters()]
    for n, a, b in zip(names, g0, g1):
        assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max()), n
    # drop-path and dropout drew masks: some block's gradient differs from a
    # run with other draws
    torch.manual_seed(4)
    model = HybridViT(**kw)
    model.load_state_dict(base.state_dict())
    cap = _Capture(list(model.parameters()))
    make_step_fns(model, cap, LossConfig(), STFTConfig(), SpecAugmentConfig(), augment=False,
                  use_attention_mask=True)[0](batch)
    assert any(not torch.equal(a, b) for a, b in zip(g0, cap.grads))


def test_remat_checkpoints_only_in_training(monkeypatch):
    """The blocks go through ``checkpoint`` in train mode only, and never
    when attention weights are asked for (the JAX condition)."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import attention

    calls = []
    real = attention.checkpoint
    monkeypatch.setattr(attention, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model = HybridViT(**SMALL, remat=True)
    x = torch.rand(1, 257, 32, 1)
    model.eval()(x)
    model.train()(x, return_attentions=True)
    assert calls == []
    model.train()(x)
    assert len(calls) == SMALL["num_layers"]
