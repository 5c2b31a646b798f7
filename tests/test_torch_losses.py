"""The port's losses against the JAX package's on the CPU: every
``combined_loss`` component (and its gradient with respect to the
prediction) with and without the frame mask and the padding rows'
``sample_valid``, log compression on and off, ``batch_si_sdr_db`` and
``create_loss_function``. Tolerance: 1e-5 relative to each value (float32,
the same formulas; SI-SDR in dB 1e-4 absolute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.training import losses as J
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training import losses as T

torch.set_num_threads(2)

ALL_ON = dict(l1_weight=1.0, mse_weight=0.5, stoi_weight=0.1, perceptual_weight=0.2,
              log_l1_weight=0.05)


def _inputs(rng):
    pred = rng.uniform(-0.1, 1.0, (3, 17, 12, 1)).astype(np.float32)
    target = rng.uniform(0.0, 1.0, (3, 17, 12, 1)).astype(np.float32)
    frame_mask = np.arange(12)[None, :] < np.array([12, 7, 0])[:, None]
    valid = np.array([True, True, False])
    return pred, target, frame_mask, valid


def _close(a, b, tol=1e-5):
    a = a.detach() if isinstance(a, torch.Tensor) else a
    assert abs(float(a) - float(b)) <= tol * max(1.0, abs(float(b))), (float(a), float(b))


@pytest.mark.parametrize("use_frame_mask", [False, True])
@pytest.mark.parametrize("use_log_compression", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
def test_combined_loss_matches_jax(use_frame_mask, use_log_compression, with_valid, rng):
    pred, target, frame_mask, valid = _inputs(rng)
    kw = dict(ALL_ON, use_frame_mask=use_frame_mask, use_log_compression=use_log_compression)
    sv = valid if with_valid else None

    def j_total(p):
        total, comps = J.combined_loss(p, jnp.asarray(target), J.LossConfig(**kw),
                                       frame_mask=jnp.asarray(frame_mask),
                                       sample_valid=None if sv is None else jnp.asarray(sv))
        return total, comps

    (_, ref), ref_grad = jax.value_and_grad(j_total, has_aux=True)(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    total, comps = T.combined_loss(tp, torch.from_numpy(target), T.LossConfig(**kw),
                                   frame_mask=torch.from_numpy(frame_mask),
                                   sample_valid=None if sv is None else torch.from_numpy(sv))
    total.backward()
    assert set(comps) == set(ref)
    for k in ref:
        _close(comps[k], ref[k])
    g, rg = tp.grad.numpy(), np.asarray(ref_grad)
    assert np.abs(g - rg).max() <= 1e-5 * np.abs(rg).max()


def test_stoi_proxy_sample_weight(rng):
    pred, target, frame_mask, valid = _inputs(rng)
    for fm in (None, frame_mask):
        ref = J.stoi_proxy_loss(jnp.asarray(pred), jnp.asarray(target),
                                None if fm is None else jnp.asarray(fm),
                                sample_weight=jnp.asarray(valid))
        got = T.stoi_proxy_loss(torch.from_numpy(pred), torch.from_numpy(target),
                                None if fm is None else torch.from_numpy(fm),
                                sample_weight=torch.from_numpy(valid))
        _close(got, ref)


def test_masked_mean_and_log_compress(rng):
    err = rng.uniform(0, 1, (2, 5, 6, 1)).astype(np.float32)
    mask = np.arange(6)[None, :] < np.array([6, 2])[:, None]
    _close(T.masked_mean(torch.from_numpy(err), torch.from_numpy(mask)),
           J.masked_mean(jnp.asarray(err), jnp.asarray(mask)))
    _close(T.masked_mean(torch.from_numpy(err), None), J.masked_mean(jnp.asarray(err), None))
    x = np.array([-0.5, 0.0, 1e-9, 3.0], np.float32)
    np.testing.assert_allclose(T.log_compress(torch.from_numpy(x), 1e-2).numpy(),
                               np.asarray(J.log_compress(jnp.asarray(x), 1e-2)), rtol=1e-6)


def test_batch_si_sdr_matches_jax(rng):
    ref = rng.standard_normal((4, 800)).astype(np.float32)
    est = (ref + 0.3 * rng.standard_normal((4, 800))).astype(np.float32)
    ref[3] = 0.0  # a silent (padding) row: a large negative, finite value
    for valid in (None, np.array([True, True, False, False])):
        got = T.batch_si_sdr_db(torch.from_numpy(ref), torch.from_numpy(est),
                                None if valid is None else torch.from_numpy(valid))
        want = J.batch_si_sdr_db(jnp.asarray(ref), jnp.asarray(est),
                                 None if valid is None else jnp.asarray(valid))
        assert np.isfinite(float(got))
        assert abs(float(got) - float(want)) <= 1e-4


def test_loss_config_and_loss_function_from_config(rng):
    config = {"training": {"loss": dict(ALL_ON, log_eps=0.02, si_sdr_weight=0.3,
                                        use_frame_mask=True)}}
    ours, ref = T.LossConfig.from_config(config), J.LossConfig.from_config(config)
    assert {k: getattr(ours, k) for k in vars(ours)} == {k: getattr(ref, k) for k in vars(ours)}
    pred, target, frame_mask, valid = _inputs(rng)
    fn, jfn = T.create_loss_function(config), J.create_loss_function(config)
    assert fn.config == ours
    total, comps = fn(torch.from_numpy(pred), torch.from_numpy(target),
                      torch.from_numpy(frame_mask), torch.from_numpy(valid))
    jtotal, _ = jfn(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(frame_mask),
                    jnp.asarray(valid))
    _close(total, jtotal)
