"""The port's train-step featurization and SpecAugment against the JAX
package's on the CPU.

``featurize_batch`` on ragged float32 and PCM16 batches: every field of
``FeaturizedBatch`` within 1e-4 absolute of the JAX one (the plain STFT's
fp32 DFT sums of 512 terms in another order; normalized magnitudes lie in
[0, 1], ``*_over_max`` in [0, 1] of the noisy max), the frame mask and the
int16 rescale exact. SpecAugment: the port's application of the JAX
function's own draws equals the JAX result within 1e-6 relative (the gain
10^(dB/20) in float32); the port's own draws are tested for their
distribution, as are the train-mode dropouts' masks and scalings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.data import augmentation as JA
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.data.pipeline import (
    featurize_batch as j_featurize_batch,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.ops.stft import (
    STFTConfig as JSTFTConfig,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data import augmentation as A
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.pipeline import (
    featurize_batch,
    int16_to_float,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models.components import (
    DropPath,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import STFTConfig

torch.set_num_threads(2)

LEN = 63 * 128  # the 64-frame bucket


def _batch(rng, int16: bool):
    lengths = np.array([LEN, 3001, 0, 700], np.int32)
    noisy = np.zeros((4, LEN), np.float32)
    clean = np.zeros((4, LEN), np.float32)
    for i, n in enumerate(lengths):
        clean[i, :n] = 0.4 * np.sin(np.arange(n) * 0.03 * (i + 1))
        noisy[i, :n] = clean[i, :n] + 0.1 * rng.standard_normal(n)
    if int16:
        noisy, clean = (np.clip(np.rint(x * 32768), -32768, 32767).astype(np.int16)
                        for x in (noisy, clean))
    return noisy, clean, lengths


@pytest.mark.parametrize("int16", [False, True])
def test_featurize_batch_matches_jax(int16, rng):
    noisy, clean, lengths = _batch(rng, int16)
    ref = j_featurize_batch(jnp.asarray(noisy), jnp.asarray(clean), jnp.asarray(lengths),
                            JSTFTConfig())
    got = featurize_batch(torch.from_numpy(noisy), torch.from_numpy(clean),
                          torch.from_numpy(lengths), STFTConfig())
    assert got._fields == ref._fields
    for name, a, b in zip(got._fields, got, ref):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, name
        if name == "frame_mask":
            np.testing.assert_array_equal(a.numpy(), b)
        elif name == "noisy_phase":  # atan2 of near-zero bins is ill-conditioned
            big = np.asarray(ref.noisy_over_max) > 1e-3
            d = np.angle(np.exp(1j * (a.numpy() - b)))
            assert np.abs(d[big]).max() < 1e-3
        else:
            np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=1e-4, err_msg=name)


def test_int16_to_float_is_exact(rng):
    x = rng.integers(-32768, 32768, 1000).astype(np.int16)
    np.testing.assert_array_equal(int16_to_float(torch.from_numpy(x)).numpy(),
                                  x.astype(np.float32) / 32768.0)


def _jax_draws(key, batch: int, f: int, t: int, cfg: JA.SpecAugmentConfig) -> A.SpecAugmentDraws:
    """The random numbers ``JA.spec_augment_batch(key, ...)`` draws, by its
    own key splits, as the port's draws."""
    fw, fs, tw, ts, on, db = [], [], [], [], [], []
    for k in jax.random.split(key, batch):
        keys = jax.random.split(k, cfg.freq_mask_num + cfg.time_mask_num + 2)
        for i, (w_out, s_out, size, max_w) in enumerate(
                [(fw, fs, f, cfg.freq_mask_width)] * cfg.freq_mask_num
                + [(tw, ts, t, cfg.time_mask_width)] * cfg.time_mask_num):
            kw, ks = jax.random.split(keys[i])
            width = int(jax.random.randint(kw, (), 0, max_w + 1))
            w_out.append(width)
            s_out.append(int(jax.random.randint(ks, (), 0, max(size - width, 1))))
        on.append(bool(jax.random.uniform(keys[-2]) < cfg.gain_prob))
        db.append(float(jax.random.uniform(keys[-1], (), minval=cfg.gain_db_range[0],
                                           maxval=cfg.gain_db_range[1])))
    band = lambda x, num: torch.tensor(x, dtype=torch.int64).reshape(batch, num)  # noqa: E731
    return A.SpecAugmentDraws(band(fw, cfg.freq_mask_num), band(fs, cfg.freq_mask_num),
                              band(tw, cfg.time_mask_num), band(ts, cfg.time_mask_num),
                              torch.tensor(on), torch.tensor(db, dtype=torch.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_augment_applies_the_jax_draws(seed, rng):
    cfg = dict(freq_mask_num=2, freq_mask_width=15, time_mask_num=2, time_mask_width=30,
               gain_prob=0.5)
    specs = rng.uniform(0, 1, (5, 257, 64)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(JA.spec_augment_batch(key, jnp.asarray(specs), JA.SpecAugmentConfig(**cfg)))
    draws = _jax_draws(key, 5, 257, 64, JA.SpecAugmentConfig(**cfg))
    got = A.apply_spec_augment(torch.from_numpy(specs), draws, A.SpecAugmentConfig(**cfg)).numpy()
    np.testing.assert_array_equal(got == 0, ref == 0)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_featurize_augments_the_noisy_input_only(rng):
    noisy, clean, lengths = _batch(rng, False)
    args = (torch.from_numpy(noisy), torch.from_numpy(clean), torch.from_numpy(lengths))
    plain = featurize_batch(*args)
    aug = featurize_batch(*args, augment_generator=torch.Generator().manual_seed(3))
    assert not torch.equal(aug.noisy_spec, plain.noisy_spec)
    for name in ("clean_spec", "noisy_over_max", "clean_over_max", "noisy_max"):
        assert torch.equal(getattr(aug, name), getattr(plain, name)), name


def test_spec_augment_draws_distribution():
    cfg = A.SpecAugmentConfig(freq_mask_num=2, freq_mask_width=15, time_mask_num=3,
                              time_mask_width=30, gain_prob=0.3, gain_db_range=(-2.0, 4.0))
    d = A.draw_spec_augment(4000, 257, 40, cfg, torch.Generator().manual_seed(0))
    assert d.freq_width.shape == (4000, 2) and d.time_width.shape == (4000, 3)
    for width, start, size, most in ((d.freq_width, d.freq_start, 257, 15),
                                     (d.time_width, d.time_start, 40, 30)):
        assert int(width.min()) == 0 and int(width.max()) == most  # U[0, max_width]
        assert set(torch.unique(width).tolist()) == set(range(most + 1))
        hi = torch.clamp(size - width, min=1)
        assert bool((start >= 0).all()) and bool((start < hi).all())  # a start that fits
        assert bool((start + width <= size).all())
    assert abs(float(d.gain_on.float().mean()) - 0.3) < 0.03
    assert float(d.gain_db.min()) >= -2.0 and float(d.gain_db.max()) < 4.0


def test_spec_augment_off_switches():
    specs = torch.rand(3, 20, 30)
    d = A.draw_spec_augment(3, 20, 30, A.SpecAugmentConfig(), torch.Generator().manual_seed(1))
    off = A.SpecAugmentConfig(enabled=False, gain_enabled=False)
    assert torch.equal(A.apply_spec_augment(specs, d, off), specs)


def test_channel_dropout_and_drop_path_distributions():
    """Channel dropout (``F.dropout2d``, flax's ``broadcast_dims=(1, 2)`` on
    NHWC): one draw per (sample, channel), kept channels scaled by 1/keep.
    ``DropPath``: one draw per sample, kept samples scaled by 1/keep; both
    identity in eval."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models.components import (
        ConvBlock,
    )

    torch.manual_seed(0)
    block = ConvBlock(1, 64, pool_size=None, dropout=0.25).train()
    x = torch.rand(64, 1, 6, 7) + 0.5
    y = block(x).flatten(2)
    block.dropout = 0.0
    ref = block(x).flatten(2)  # the same batch statistics, nothing dropped
    live = (ref != 0).any(dim=2)  # (sample, channel) pairs not all zero after ReLU
    dropped = (y == 0).all(dim=2) & live
    kept = live & ~dropped
    assert abs(float(dropped.sum() / live.sum()) - 0.25) < 0.03
    torch.testing.assert_close(y[kept], ref[kept] / 0.75)
    assert torch.equal(ref[~live], y[~live])

    dp = DropPath(0.3).train()
    z = torch.ones(20000, 5, 3)
    out = dp(z)
    per_sample = out.flatten(1)
    assert bool(((per_sample == 0).all(dim=1) | (per_sample == 1 / 0.7).all(dim=1)).all())
    assert abs(float((per_sample[:, 0] == 0).float().mean()) - 0.3) < 0.02
    assert torch.equal(dp.eval()(z), z)
