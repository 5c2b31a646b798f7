"""PyTorch port's BatchNorm folding (``models/fold.py``, the enhancer's
``fold_bn``) against the JAX package's ``fold_batchnorm``.

Every test first gives the BatchNorm statistics and affine parameters
seeded non-trivial values: at initialization (mean 0, var 1, scale 1,
bias 0) the fold is nearly the identity and would test nothing.

Tolerances: the folded weights equal the JAX fold's exactly (the same
float32 operations, ``gamma / sqrt(var + eps)``, ``W * s``,
``beta - mean * s``, correctly rounded on both sides). Model outputs
1e-4 absolute on the Tanh output, the port's model-output limit against
the JAX package (fp32 through ~20 layers in other summation orders); the
folded against the unfolded port model within the same 1e-4, since a conv
with a bias sums in another order than the conv and then BatchNorm
(measured <= 4.8e-6). Enhanced waveforms, folded against unfolded: 1e-4,
the JAX test's limit (``tests/test_round4_fixes.py``).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.models import (
    HybridViT as JHybridViT,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.models.fold import (
    fold_batchnorm as j_fold_batchnorm,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.utils.checkpoint import (
    load_model_weights as j_load_model_weights,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
    AudioEnhancer,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import HybridViT
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models.components import (
    BatchNorm,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models.fold import (
    fold_batchnorm,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
    flax_to_state_dict,
    load_model_weights,
    read_meta,
    save_checkpoint,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from fixtures.make_tiny_denoiser import TINY  # noqa: E402

torch.set_num_threads(2)

ATOL = 1e-4
FIXTURES = Path(__file__).parent / "fixtures"
SMALL = dict(embed_dim=64, num_heads=4, num_layers=2, mlp_ratio=2.0,
             encoder_channels=(16, 32, 64), decoder_channels=(32, 16, 8, 1),
             dropout=0.0, attn_dropout=0.0, drop_path_rate=0.0,
             pos_embed_type="factored_2d")
HEADS = [dict(head_type="resize"), dict(head_type="fullres_mask", head_channels=8)]


def _np_tree(tree):
    """A nested dict of writable numpy arrays."""
    if hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.array(tree)


def _perturb_bn(variables, rng):
    """``variables`` with every BatchNorm's scale, bias, mean and var drawn
    from ``rng`` (var in [0.2, 3], scale in [0.5, 1.5])."""
    def walk(params, stats):
        for key, sub in params.items():
            if key == "BatchNorm_0":
                n = sub["scale"].shape
                sub["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                sub["bias"] = rng.normal(0.0, 0.3, n).astype(np.float32)
                stats[key]["mean"] = rng.normal(0.0, 0.5, n).astype(np.float32)
                stats[key]["var"] = rng.uniform(0.2, 3.0, n).astype(np.float32)
            elif isinstance(sub, dict):
                walk(sub, stats.get(key, {}))

    variables = _np_tree(variables)
    walk(variables["params"], variables["batch_stats"])
    return variables


@pytest.fixture(scope="module", params=range(len(HEADS)), ids=["resize", "fullres_mask"])
def models(request):
    """(JAX model, its variables with non-trivial BatchNorm, the port model
    holding the same weights)."""
    kw = dict(SMALL, **HEADS[request.param])
    jm = JHybridViT(**kw)
    x = jnp.zeros((1, 257, 64, 1), jnp.float32)
    variables = jm.init(jax.random.PRNGKey(request.param), x, train=False)
    variables = _perturb_bn(variables, np.random.default_rng(request.param))
    tm = HybridViT(**kw).eval()
    tm.load_state_dict(flax_to_state_dict(variables), strict=False)
    return jm, variables, tm, kw


def _spec(seed, t=64):
    return np.random.default_rng(seed).random((2, 257, t, 1)).astype(np.float32)


def _run(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x)).numpy()


def test_fold_matches_jax_fold(models):
    jm, variables, tm, _ = models
    _, jvars = j_fold_batchnorm(jm, variables)
    want = flax_to_state_dict(_np_tree(jvars))
    got = fold_batchnorm(tm).state_dict()
    assert sorted(got) == sorted(want)
    assert not any(".bn." in k for k in got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_folded_model_matches_jax_folded(models):
    jm, variables, tm, _ = models
    jfm, jvars = j_fold_batchnorm(jm, variables)
    x = _spec(1)
    ref = np.asarray(jfm.apply(jvars, jnp.asarray(x), train=False))
    np.testing.assert_allclose(_run(fold_batchnorm(tm), x), ref, atol=ATOL, rtol=0)


def test_folded_matches_unfolded_and_leaves_the_original(models):
    _, _, tm, kw = models
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    folded = fold_batchnorm(tm)
    x = _spec(2, t=96)
    np.testing.assert_allclose(_run(folded, x), _run(tm, x), atol=ATOL, rtol=0)
    after = tm.state_dict()
    assert sorted(after) == sorted(before)
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert folded.fold_bn and not getattr(tm, "fold_bn")
    # the folded model is the fold_bn=True construction, name for name
    assert sorted(folded.state_dict()) == sorted(HybridViT(**kw, fold_bn=True).state_dict())


def test_folded_checkpoint_reads_back_in_both_packages(models, tmp_path):
    jm, variables, tm, kw = models
    folded = fold_batchnorm(tm)
    save_checkpoint(tmp_path / "ck", folded)
    back = load_model_weights(tmp_path / "ck", HybridViT(**kw, fold_bn=True))
    x = _spec(3)
    np.testing.assert_array_equal(_run(back, x), _run(folded, x))
    jfm = JHybridViT(**kw, fold_bn=True)
    template = jfm.init(jax.random.PRNGKey(0), jnp.zeros((1, 257, 64, 1)), train=False)
    jvars = j_load_model_weights(tmp_path / "ck", template)
    ref = np.asarray(jfm.apply(jvars, jnp.asarray(x), train=False))
    np.testing.assert_allclose(_run(folded, x), ref, atol=ATOL, rtol=0)


def test_leftover_batchnorm_raises(models):
    _, _, tm, _ = models
    stray = fold_batchnorm(tm)
    stray.extra = BatchNorm(4)  # a BatchNorm outside any conv block
    with pytest.raises(ValueError, match="could not fold"):
        fold_batchnorm(stray)
    biased = HybridViT(**dict(SMALL, fold_bn=True))
    biased.encoder[0].bn = BatchNorm(16)  # after a conv that has a bias
    with pytest.raises(ValueError, match=r"encoder\.0\.bn"):
        fold_batchnorm(biased)


@pytest.mark.parametrize("fixture", ["tiny_denoiser", "tiny_denoiser_mask"])
def test_enhancer_fold_bn_matches_unfolded(fixture):
    """As JAX ``test_fold_bn_and_dft_precision``: folding is invisible end to
    end, on the trained fixture with perturbed BatchNorm."""
    path = FIXTURES / fixture
    cfg = read_meta(path)["config"]
    model = load_model_weights(path, HybridViT(**TINY))
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                n = mod.num_features
                mod.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n)))
                mod.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.3, n)))
                mod.running_mean.copy_(torch.from_numpy(rng.normal(0.0, 0.5, n)))
                mod.running_var.copy_(torch.from_numpy(rng.uniform(0.2, 3.0, n)))
    t = np.arange(int(16000 * 0.4)) / 16000
    noisy = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.1 * rng.standard_normal(len(t))).astype(
        np.float32)
    kw = dict(device="cpu", buckets=(64, 128), blend=1.0)
    base = AudioEnhancer(model, cfg, **kw).enhance(noisy)
    folded = AudioEnhancer(model, cfg, fold_bn=True, **kw).enhance(noisy)
    assert np.isfinite(base).all() and np.abs(base).max() > 1e-3
    assert float(np.abs(folded - base).max()) < 1e-4
