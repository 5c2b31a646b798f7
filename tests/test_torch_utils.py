"""The port's remaining utilities against the JAX package: SpecAugment's
single-spectrogram and augmenter forms (fed the JAX function's own draws),
``count_parameters``, ``save_config``/``print_config``, weights-only
checkpoints and ``checkpoint_info``, ``export_program``, the six plots, the
packages' exports and the small names (``Stopwatch``, ``METRIC_KEYS``,
``set_seed``).

Tolerances: SpecAugment, the counts, the config and the checkpoints are
exact; the exported program's output 1e-6 of the module's (the same CPU
operators, traced).
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.cli import train as j_train_cli
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.data import augmentation as JA
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.evaluation import (
    evaluator as j_evaluator,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.models import (
    HybridViT as JHybridViT,
    count_parameters as j_count_parameters,
    create_hybrid_vit as j_create_hybrid_vit,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.utils import (
    checkpoint as JC,
    config as JCFG,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch import (
    data,
    models,
    ops,
    utils,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli import train as train_cli
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data import augmentation as A
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.evaluation import evaluator
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
    HybridViT,
    count_parameters,
    create_hybrid_vit,
    init_weights,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils import (
    checkpoint as C,
    config as CFG,
    visualization as V,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.logging import (
    Stopwatch,
)
from fixtures.make_tiny_denoiser import TINY
from test_torch_featurize import _jax_draws

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
AUG_CONFIG = {"augmentation": {
    "spec_augment": {"freq_mask_num": 1, "freq_mask_width": 20, "time_mask_num": 3,
                     "time_mask_width": 10},
    "random_gain": {"probability": 0.9, "gain_db_range": [-6.0, 6.0]}}}


def _tiny_model(seed=0):
    return init_weights(HybridViT(**TINY), torch.Generator().manual_seed(seed)).eval()


# ---------------------------------------------------------------------------
# SpecAugment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("config", [AUG_CONFIG, None], ids=["config", "defaults"])
def test_spectrogram_augmenter_applies_the_jax_draws(rng, seed, config):
    """One spectrogram (``spec_augment``, ``augment``) and a batch
    (``augment_batch``): JAX's key ``k`` for one spectrogram is the batch
    function's ``split(key, 1)[0]``, so ``_jax_draws(key, 1, ...)`` are its
    draws."""
    ref, ours = JA.SpectrogramAugmenter(config), A.SpectrogramAugmenter(config)
    assert ours.cfg == A.SpecAugmentConfig(**{
        k: getattr(ref.cfg, k) for k in A.SpecAugmentConfig.__dataclass_fields__})
    key = jax.random.PRNGKey(seed)
    spec = rng.uniform(0, 1, (257, 48)).astype(np.float32)
    one = _jax_draws(key, 1, 257, 48, ref.cfg)
    want = np.asarray(ref.augment(jax.random.split(key, 1)[0], jnp.asarray(spec)))
    np.testing.assert_array_equal(ours.augment(torch.from_numpy(spec), draws=one).numpy(), want)
    np.testing.assert_array_equal(
        A.spec_augment(torch.from_numpy(spec), ours.cfg, draws=one).numpy(), want)
    specs = rng.uniform(0, 1, (4, 257, 48)).astype(np.float32)
    want = np.asarray(ref.augment_batch(key, jnp.asarray(specs)))
    got = ours.augment_batch(torch.from_numpy(specs), draws=_jax_draws(key, 4, 257, 48, ref.cfg))
    np.testing.assert_array_equal(got.numpy(), want)


def test_spec_augment_draws_from_a_generator(rng):
    spec = torch.from_numpy(rng.uniform(0.5, 1, (257, 64)).astype(np.float32))
    aug = A.SpectrogramAugmenter(AUG_CONFIG)
    a = aug.augment(spec, torch.Generator().manual_seed(5))
    b = A.spec_augment(spec, aug.cfg, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and a.shape == spec.shape and bool((a == 0).any())
    batch = aug.augment_batch(spec.expand(3, -1, -1).contiguous(), torch.Generator().manual_seed(5))
    assert batch.shape == (3, 257, 64)
    with pytest.raises(ValueError, match="generator"):
        A.spec_augment(spec, aug.cfg)


# ---------------------------------------------------------------------------
# count_parameters
# ---------------------------------------------------------------------------


def _jax_counts(jm, x):
    template = jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a, train=False),
                              jnp.asarray(x))
    return j_count_parameters(template)


@pytest.mark.parametrize("head", ["resize", "fullres_mask"])
def test_count_parameters_tiny(head):
    config = {"model": {"head": head, "head_channels": 8, "encoder": {"channels": [16, 32, 64]},
                        "transformer": {"embed_dim": 128, "num_heads": 4, "num_layers": 2,
                                        "mlp_ratio": 2, "pos_embed": "factored_2d"},
                        "decoder": {"channels": [32, 16, 8, 1]}}}
    x = np.zeros((1, 257, 64, 1), np.float32)
    counts = count_parameters(create_hybrid_vit(config))
    assert counts == _jax_counts(j_create_hybrid_vit(config), x)
    assert (counts["head"] > 0) == (head == "fullres_mask")
    assert count_parameters(HybridViT(**TINY)) == _jax_counts(JHybridViT(**TINY), x)


def test_count_parameters_28m_default_config():
    config = CFG.load_all_configs(ROOT / "config")
    counts = count_parameters(create_hybrid_vit(config))
    assert counts == _jax_counts(j_create_hybrid_vit(config), np.zeros((1, 257, 64, 1), np.float32))
    assert 28e6 < counts["total"] < 29e6 and counts["trainable"] == counts["total"]


# ---------------------------------------------------------------------------
# config, checkpoints, export
# ---------------------------------------------------------------------------


def test_save_config_is_read_back_by_jax_and_prints_the_same(tmp_path, capsys):
    config = CFG.load_all_configs(ROOT / "config")
    config["extra"] = {"eps": 1e-8, "name": "run: one", "flags": [True, False], "none": None,
                       "lr": 3.0e-4, "sizes": [64, 128]}
    CFG.save_config(config, tmp_path / "out" / "config.yaml")
    assert JCFG.load_config(tmp_path / "out" / "config.yaml") == config
    assert CFG.load_config(tmp_path / "out" / "config.yaml") == config
    text = CFG.print_config(config)
    printed = capsys.readouterr().out
    assert text == JCFG.print_config(config)
    assert printed == capsys.readouterr().out == text + "\n"
    assert json.loads(text) == json.loads(json.dumps(config, default=str))


def test_save_model_weights_is_read_by_jax(tmp_path):
    model = _tiny_model(3)
    with torch.no_grad():  # non-trivial BatchNorm statistics
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.uniform_(0.5, 1.5)
    path = C.save_model_weights(tmp_path / "w", model, config={"model": {"x": 1}})
    template = jax.eval_shape(
        lambda a: JHybridViT(**TINY).init(jax.random.PRNGKey(0), a, train=False),
        jnp.zeros((1, 257, 64, 1), jnp.float32))
    variables = JC.load_model_weights(path, template)
    sd = C.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, variables))
    own = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(sd) == set(own)
    for k, v in own.items():
        assert torch.equal(sd[k], v), k
    info = C.checkpoint_info(path)
    assert info == JC.checkpoint_info(path)
    assert info["config"] == {"model": {"x": 1}} and info["size_bytes"] > 0


def test_export_program_round_trip(tmp_path, rng):
    model = _tiny_model(1)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 257, 64, 1)).astype(np.float32))
    path = C.export_program(tmp_path / "sub" / "model.pt2", model, (x,))
    program = torch.export.load(str(path))
    with torch.no_grad():
        want = model(x)
        got = program.module()(x)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6


def test_export_program_refuses_a_model_off_the_cpu(tmp_path):
    """Off the CPU and CUDA (the meta device) it raises before tracing
    anything: the kernels' ops compute on cpu or cuda (a CUDA model exports
    on the card: tests/test_torch_cuda.py)."""
    model = _tiny_model()
    x = torch.zeros(1, 257, 64, 1)
    with pytest.raises(ValueError, match="meta"):
        C.export_program(tmp_path / "m.pt2", model, (x.to("meta"),))
    with pytest.raises(ValueError, match="meta"):
        C.export_program(tmp_path / "m.pt2", model.to("meta"), (x,))
    assert not (tmp_path / "m.pt2").exists()


# ---------------------------------------------------------------------------
# plots
# ---------------------------------------------------------------------------


def test_six_plots_written(tmp_path, rng):
    pytest.importorskip("matplotlib")
    wav = (0.3 * np.sin(np.arange(8000) * 0.05) + 0.01 * rng.standard_normal(8000)).astype(
        np.float32)
    paths = [
        V.plot_waveform(wav, save_path=tmp_path / "w.png"),
        V.plot_spectrogram(wav, save_path=tmp_path / "s.png"),
        V.plot_spectrogram(np.abs(rng.standard_normal((257, 40))), save_path=tmp_path / "m.png"),
        V.plot_comparison(wav, wav * 0.9, wav * 0.8, save_path=tmp_path / "c.png"),
        V.plot_loss_curves([1.0, 0.5, 0.3], [1.1, 0.6, 0.4], save_path=tmp_path / "l.png"),
        V.plot_attention_map(rng.random((2, 4, 16, 16)), head=1, save_path=tmp_path / "a.png"),
        V.plot_metrics_comparison({"si_sdr": {"noisy": 2.0, "enhanced": 9.0},
                                   "stoi": {"noisy": 0.8, "enhanced": 0.9}},
                                  save_path=tmp_path / "b.png"),
        V.plot_metrics_comparison({"si_sdr": 9.0, "stoi": 0.9}, save_path=tmp_path / "f.png"),
    ]
    for p in paths:
        assert Path(p).stat().st_size > 1000, p
    fig = V.plot_waveform(wav)
    assert fig.__class__.__name__ == "Figure"


def test_plots_without_matplotlib_raise_import_error():
    """Importing the module and the packages needs no matplotlib (nor any
    kernel build or native compile); a plot call names what is missing."""
    code = (
        "import sys; sys.modules['matplotlib'] = None\n"
        "import speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops\n"
        "import speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models\n"
        "import speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data\n"
        "import speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils\n"
        "from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils import "
        "visualization as V\n"
        "from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import "
        "kernels\n"
        "from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch import native\n"
        "assert kernels._lib is None and native._lib is None and native._error is None\n"
        "assert 'jax' not in sys.modules\n"
        "try:\n    V.plot_waveform([0.0, 1.0])\nexcept ImportError as e:\n"
        "    assert 'matplotlib' in str(e); print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---------------------------------------------------------------------------
# exports and small names
# ---------------------------------------------------------------------------


def test_package_exports_mirror_the_jax_package():
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu import (
        data as jdata,
        models as jmodels,
        ops as jops,
        utils as jutils,
    )

    def public(mod):
        return {n for n in vars(mod) if not n.startswith("_") and not isinstance(
            getattr(mod, n), type(sys)) or n == "audio"}

    jax_only = {"export_stablehlo", "enable_compilation_cache", "jit_init", "set_prng_impl"}
    for ours, ref in ((ops, jops), (models, jmodels), (data, jdata), (utils, jutils)):
        missing = public(ref) - public(ours) - jax_only - {"annotations"}
        assert not missing, (ours.__name__, missing)
    assert utils.export_program is C.export_program
    q = torch.randn(1, 2, 5, 8)
    torch.testing.assert_close(models.sdpa_reference(q, q, q, scale=0.3),
                               torch.softmax(q @ q.transpose(-1, -2) * 0.3, -1) @ q)
    assert callable(ops.stft) and ops.audio.mix_at_snr is not None


def test_small_names():
    assert evaluator.METRIC_KEYS == j_evaluator.METRIC_KEYS
    sw = Stopwatch()
    sw.tick(1.5)
    sw.tick(0.5)
    time.sleep(0.01)
    assert sw.steps == 2 and sw.audio_seconds == 2.0
    assert 0 < sw.steps_per_second < 200 and sw.audio_seconds_per_second > 0
    sw.reset()
    assert sw.steps == 0
    train_cli.set_seed(11)
    a = (np.random.rand(), torch.rand(3))
    j_train_cli.set_seed(11)
    b = np.random.rand()
    train_cli.set_seed(11)
    assert a[0] == b == np.random.rand() and torch.equal(a[1], torch.rand(3))
