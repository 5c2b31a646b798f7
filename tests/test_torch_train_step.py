"""One train step of the port against one JAX ``make_step_fns`` train step
on the CPU, from the same weights (``flax_to_state_dict``) and batch.

Dropout 0 and SpecAugment off (JAX's random streams cannot be reproduced in
torch). Both output modes and heads, with and without ``mask_padding``, the
JAX side on its explicit-weights attention or its ``fused_attention``
(``_xla_attention`` and ``_fused_bwd`` on the CPU). The JAX step's gradients
are captured exactly by a pass-through optax transform whose state is the
gradient.

The reference runs under ``jax.enable_x64``, where the JAX step computes
(mostly) in float64: its float32 step on the CPU is off its own float64 step
by up to 7% of a leaf's largest gradient on these batches (measured), too
far to hold the port to. The port computes in float32.

Tolerances: loss components 1e-5 absolute (SI-SDR in dB: 1e-4); the new
BatchNorm statistics 1e-5 absolute; gradients: every element within 1e-3 of
the model's largest gradient, and each leaf within 5e-3 of its own largest.
The per-leaf bound is loose for the first convolutions' weights: BatchNorm's
backward makes each channel's sum of dout over positions vanish, so their
gradient, a sum of dout times the input, cancels the input's mean and
amplifies rounding of the spectrogram. Measured: up to 4e-3 of that leaf's
largest gradient on int16 batches and 4.9e-4 of the largest of the model
(the port in float64 then still differs,
the port in float32 agrees with it to 3e-5); every other leaf within 1e-4.
Gradients, not post-Adam parameters, are compared: Adam's first step turns a
gradient near 0 into a step of lr either way. The fullres head's cases are in
``test_torch_train_step_fullres.py``.
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.data.augmentation import (
    SpecAugmentConfig as JSpecAugmentConfig,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.data.pipeline import (
    featurize_batch as j_featurize_batch,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.models import HybridViT as JHybridViT
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.ops.stft import STFTConfig as JSTFTConfig
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.training.losses import (
    LossConfig as JLossConfig,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.training.trainer import (
    TrainState,
    make_step_fns as j_make_step_fns,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.augmentation import (
    SpecAugmentConfig,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.pipeline import (
    featurize_batch as port_featurize,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import HybridViT
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training import (
    trainer as trainer_module,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import STFTConfig
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.losses import LossConfig
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.optimizer import Optimizer
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.trainer import (
    make_step_fns,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
    flax_to_state_dict,
)
from test_torch_model import SMALL, _jax_variables

torch.set_num_threads(2)

LEN = 63 * 128  # the 64-frame bucket


def make_batch(rng, int16: bool, length: int = LEN):
    """Three rows of the 64-frame bucket (``length`` samples: 63 hops): a
    full clip, a short one, and a padding row (valid False, length 0), as
    the loader pads them."""
    lengths = np.array([length, 5000, 0], np.int32)
    noisy = np.zeros((3, length), np.float32)
    clean = np.zeros((3, length), np.float32)
    for i, n in enumerate(lengths[:2]):
        clean[i, :n] = 0.3 * np.sin(np.arange(n) * 0.05 * (i + 1))
        noisy[i, :n] = clean[i, :n] + 0.1 * rng.standard_normal(n)
    if int16:
        noisy, clean = (np.clip(np.rint(x * 32768), -32768, 32767).astype(np.int16)
                        for x in (noisy, clean))
    return {"noisy_audio": noisy, "clean_audio": clean, "length": lengths,
            "valid": np.array([True, True, False])}


class _Capture:
    """Stands in for the optimizer: keeps the gradients it is handed."""

    def __init__(self, params):
        self.params = params
        self.grads = None

    def step(self, grads):
        self.grads = grads


_GRAD_CAPTURE = optax.GradientTransformation(
    lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
    lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
)


def _jax_step(jm, variables, batch, loss_kw, stft_kw=None, **kw):
    with jax.enable_x64(True):
        step, _ = j_make_step_fns(jm, _GRAD_CAPTURE, JLossConfig(**loss_kw),
                                  JSTFTConfig(**(stft_kw or {})), JSpecAugmentConfig(),
                                  augment=False, **kw)
        state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=_GRAD_CAPTURE.init(variables["params"]),
                           step=jnp.asarray(0, jnp.int32))
        new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, {"params": new.opt_state,
                                                   "batch_stats": new.batch_stats})
        return flax_to_state_dict(tree), {k: float(v) for k, v in metrics.items()}


@contextlib.contextmanager
def _model_input_from_jax(batch, stft_kw=None):
    """The port's train step with the JAX featurizer's noisy spectrogram
    (float32 in both steps, also under ``jax.enable_x64``) as the model's
    input; every other featurized tensor stays the port's own."""
    with jax.enable_x64(True):
        spec = torch.from_numpy(np.array(j_featurize_batch(
            *(jnp.asarray(batch[k]) for k in ("noisy_audio", "clean_audio", "length")),
            JSTFTConfig(**(stft_kw or {}))).noisy_spec))

    def featurize(*args, **kwargs):
        return port_featurize(*args, **kwargs)._replace(noisy_spec=spec)

    with mock.patch.object(trainer_module, "featurize_batch", featurize):
        yield


def check_train_step(head, mode, mask_padding, pos, fused, int16, rng, jax_kw=None,
                     port_kw=None, same_model_input=False, stft_kw=None):
    """``jax_kw``/``port_kw``: more keyword arguments of the JAX and the
    port model (compute dtype, remat, attention type). With
    ``same_model_input`` the port's step feeds the model the JAX
    featurizer's noisy spectrogram (see ``test_torch_bf16.py``).
    ``stft_kw``: the STFT geometry of both steps (default 512/128)."""
    kw = dict(SMALL, head_type=head, head_channels=8, pos_embed_type=pos)
    jm = JHybridViT(**kw, use_pallas_attention=fused, **(jax_kw or {}))
    stft_cfg = STFTConfig(**(stft_kw or {}))
    variables = _jax_variables(jm, np.zeros((1, stft_cfg.num_bins, 64, 1), np.float32), rng)
    batch = make_batch(rng, int16, 63 * stft_cfg.hop_length)
    # the SI-SDR term in mask mode (its magnitude-mode use warns, ROADMAP section 3)
    loss_kw = dict(log_l1_weight=0.05, si_sdr_weight=0.01 if mode == "mask" else 0.0)
    ref, ref_metrics = _jax_step(jm, variables, batch, loss_kw, stft_kw,
                                 use_attention_mask=mask_padding, output_mode=mode)

    model = HybridViT(**kw, **(port_kw or {}))
    model.load_state_dict(flax_to_state_dict(variables))
    names = [n for n, _ in model.named_parameters()]
    cap = _Capture(list(model.parameters()))
    step, _ = make_step_fns(model, cap, LossConfig(**loss_kw), stft_cfg, SpecAugmentConfig(),
                            augment=False, use_attention_mask=mask_padding, output_mode=mode)
    with (_model_input_from_jax(batch, stft_kw) if same_model_input
          else contextlib.nullcontext()):
        metrics = step({k: torch.from_numpy(v) for k, v in batch.items()})

    assert set(metrics) == set(ref_metrics)
    for k, v in metrics.items():
        tol = 1e-4 if k == "si_sdr_db" else 1e-5
        assert abs(float(v) - ref_metrics[k]) <= tol * (1 if k != "grad_norm" else max(1, ref_metrics[k])), k
    errs = {n: float((g - ref[n].float()).abs().max()) for n, g in zip(names, cap.grads)}
    scale = max(float(ref[n].abs().max()) for n in names)
    assert max(errs.values()) <= 1e-3 * scale, max(errs, key=errs.get)
    for n, e in errs.items():
        assert e <= 5e-3 * float(ref[n].abs().max()), n
    stats = {k: v for k, v in model.state_dict().items() if "running" in k}
    assert stats and set(stats) == {k for k in ref if "running" in k}
    for k, v in stats.items():
        assert float((v - ref[k].float()).abs().max()) <= 1e-5, k


@pytest.mark.parametrize("mode,mask_padding,fused,int16", [
    ("magnitude", False, False, False), ("mask", True, True, True)],
    ids=["magnitude", "mask-masked"])
def test_train_step_matches_jax(mode, mask_padding, fused, int16, rng):
    """The resize head with the learned 1-D positional table."""
    check_train_step("resize", mode, mask_padding, "learned_1d", fused, int16, rng)


def test_nonfinite_step_keeps_the_whole_state(rng):
    """A batch with a NaN sample: no parameter, optimizer moment or count,
    or BatchNorm statistic moves; the metrics are zero but
    ``nonfinite_skipped``; the next finite batch trains as usual."""
    model = HybridViT(**SMALL).train()
    opt = Optimizer(list(model.parameters()), "adamw", lr=1e-3)
    step, _ = make_step_fns(model, opt, LossConfig(), STFTConfig(), SpecAugmentConfig(),
                            augment=False)
    good = {k: torch.from_numpy(v) for k, v in make_batch(rng, False).items()}
    step(good)
    before = ({k: v.clone() for k, v in model.state_dict().items()},
              [m.clone() for m in opt.mu], [v.clone() for v in opt.nu], opt.count)
    bad = dict(good, noisy_audio=good["noisy_audio"].clone())
    bad["noisy_audio"][0, 100] = float("nan")
    metrics = step(bad)
    assert float(metrics["nonfinite_skipped"]) == 1.0
    assert all(float(v) == 0.0 for k, v in metrics.items() if k != "nonfinite_skipped")
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[0][k]), k
    assert all(torch.equal(a, b) for a, b in zip(opt.mu, before[1]))
    assert all(torch.equal(a, b) for a, b in zip(opt.nu, before[2]))
    assert opt.count == before[3]
    metrics = step(good)
    assert float(metrics["nonfinite_skipped"]) == 0.0 and opt.count == before[3] + 1
