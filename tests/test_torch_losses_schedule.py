"""The port's standalone losses and step schedule against the JAX
package's on the CPU.

``spectrogram_loss`` (L1, MSE, L1+MSE; with and without a frame mask; with
log compression) and ``multi_resolution_stft_loss`` (512/1024/2048 with hops
128/256/512, periodic Hann, reflect centre, through the plain
differentiable STFT): values within 1e-5 relative, against ``jax.grad`` of
the JAX function in float32. Gradients with respect to the prediction:
the spectrogram loss's within 1e-4 of the largest; the multi-resolution
loss's, with respect to the waveform, within 5e-3 of the largest. Its log
term's gradient carries 1/(|X| + 1e-5) of each bin, and float32 DFT sums in
another order put the smallest bins' magnitudes up to 2e-4 apart, relative
(both packages' STFTs compute in float32, so neither is the exact one):
measured 1.5e-3 of the largest gradient on these signals.
``warmup_cosine_step_schedule`` against ``optax.warmup_cosine_decay_schedule``
at steps 0 to total + 5, warmup 0 included, within 1e-6 of the peak
(optax computes in float32; near the end of the cosine 1 + cos cancels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.training.losses import (
    multi_resolution_stft_loss as j_mrstft,
    spectrogram_loss as j_spectrogram_loss,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.training.optimizer import (
    warmup_cosine_step_schedule as j_schedule,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training import (
    multi_resolution_stft_loss,
    spectrogram_loss,
    warmup_cosine_step_schedule,
)

torch.set_num_threads(2)


def _value_and_grad(fn, *args):
    leaves = [torch.tensor(args[0], requires_grad=True)] + [
        None if a is None else torch.tensor(a) for a in args[1:]]
    out = fn(*leaves)
    (g,) = torch.autograd.grad(out, leaves[0])
    return float(out), g.detach().numpy()


def _check(got, want, grad_tol=1e-4):
    (v, g), (jv, jg) = got, want
    assert v == pytest.approx(float(jv), rel=1e-5)
    np.testing.assert_allclose(g, np.asarray(jg), atol=grad_tol * float(np.abs(jg).max()), rtol=0)


@pytest.mark.parametrize("loss_type", ["l1", "mse", "l1+mse"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("log", [False, True])
def test_spectrogram_loss_matches_jax(loss_type, masked, log, rng):
    pred = rng.uniform(-0.2, 1.0, (2, 33, 20, 1)).astype(np.float32)
    target = rng.uniform(0.0, 1.0, (2, 33, 20, 1)).astype(np.float32)
    mask = (np.arange(20)[None, :] < np.array([[20], [13]])) if masked else None
    kw = dict(loss_type=loss_type, use_log_compression=log)
    got = _value_and_grad(lambda p, t, m: spectrogram_loss(p, t, frame_mask=m, **kw),
                          pred, target, mask)
    want = jax.value_and_grad(lambda p: j_spectrogram_loss(
        p, jnp.asarray(target), frame_mask=None if mask is None else jnp.asarray(mask), **kw))(
        jnp.asarray(pred))
    _check(got, want)


def test_spectrogram_loss_rejects_an_unknown_type():
    x = torch.zeros(1, 3, 4, 1)
    with pytest.raises(ValueError, match="Unknown loss type"):
        spectrogram_loss(x, x, loss_type="huber")


def test_multi_resolution_stft_loss_matches_jax(rng):
    """Broadband waveforms: in a near-silent bin (a pure tone's) the log
    floor 1e-5 lies under float32's DFT rounding, so the log term is
    ill-conditioned there in both packages."""
    target = (0.1 * rng.standard_normal((2, 8000))).astype(np.float32)
    pred = (target + 0.05 * rng.standard_normal(target.shape)).astype(np.float32)
    got = _value_and_grad(multi_resolution_stft_loss, pred, target)
    want = jax.value_and_grad(lambda p: j_mrstft(p, jnp.asarray(target)))(jnp.asarray(pred))
    _check(got, want, grad_tol=5e-3)
    assert got[0] > 0 and multi_resolution_stft_loss(
        torch.from_numpy(target), torch.from_numpy(target)) < 1e-3


@pytest.mark.parametrize("warmup,total", [(0, 20), (5, 20), (1, 2)])
def test_warmup_cosine_step_schedule_matches_optax(warmup, total):
    ours = warmup_cosine_step_schedule(3e-4, warmup, total, min_lr=1e-6)
    ref = j_schedule(3e-4, warmup, total, min_lr=1e-6)
    for step in range(total + 6):
        assert ours(step) == pytest.approx(float(ref(step)), abs=1e-6 * 3e-4), step
    assert ours(0) == (0.0 if warmup else 3e-4) and ours(total + 5) == pytest.approx(1e-6)
    assert isinstance(ours(3), float)
    assert callable(optax.warmup_cosine_decay_schedule)  # the JAX one's definition
