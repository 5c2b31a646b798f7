"""Every STFT geometry and head dim the JAX package runs, on the port.

The FFT kernels K1 and K3 take an even ``n_fft`` from 128 to 2048 whose
half is 2^a 3^b 5^c (CMGAN's 400/100 and the 320/160 front end among them);
K1g and K3g (``csrc/stft_dft.cu``, ``csrc/istft_dft.cu``) take every other
geometry, and ``cuda_stft.route`` picks one from the config alone. K2 runs
any head dim up to 128 on the next larger instance, zero-padded, and above
128 its sliced instance, zero-padded to whole 128-column slices. The
kernels run only on a card; this file holds, on the CPU:

- the port's plain STFT and iSTFT against the JAX package's Pallas kernels
  in interpret mode (where the hop divides ``n_fft``) or its matmul path
  (elsewhere), at each geometry ``chip_smoke.py`` phase 16 runs;
- a numpy model of K1g's and K3g's index math (the gather with its edge
  reflection, the column tiles of their matrices, the gather overlap-add's
  frame ranges) against the plain versions, as ``test_torch_fft_plan.py``
  does for K1 and K3;
- the route for each geometry, through the CUDA impls with the launch
  recorded instead of made;
- the enhancer, a train step and a D = 48 model, port against the JAX
  package, at 400/100/400, and models at D = 192 and 256;
- K2's zero padding, emulated by the plain version at the padded head dim,
  and a model of the sliced instance's schedule (each output slice's block
  summing the logits over every slice, its own last).

Tolerances: STFT 2e-4 absolute and iSTFT 2e-5 of the larger of 1 and the
output's peak (fp32 sums of up to 4096 products in other orders; the
window-sum divide scales both sides' rounding up where the window sum is
small, near the ends of the random spectra here: up to 65 at 400/160); the
numpy models 1e-5 of the largest value (as
``test_torch_fft_plan.py``); the enhancer 5e-5 (float32 I/O, as
``test_torch_enhancer.py``); the train step as ``test_torch_train_step.py``;
the models 1e-4 (as ``test_torch_model.py``); the padded K2 against the
unpadded plain version 1e-6 (the zero columns add exact zeros; only the
matmuls' blocking may differ).
"""

import contextlib
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.inference.enhancer import (
    AudioEnhancer as JAudioEnhancer,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.models import HybridViT as JHybridViT
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.ops.pallas_stft import (
    pallas_istft,
    pallas_stft,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.ops.stft import (
    STFTConfig as JConfig,
    reconstruct as j_reconstruct,
    stft as j_stft,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.utils.checkpoint import (
    load_model_weights as j_load_model_weights,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
    AudioEnhancer,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import HybridViT
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
    cuda_attention,
    cuda_stft,
    kernels,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import (
    STFTConfig,
    center_pad,
    istft_output_span,
    window_sumsquare_denominator,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
    flax_to_state_dict,
    load_model_weights,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from fixtures.make_tiny_denoiser import TINY  # noqa: E402
from test_torch_model import SMALL, _jax_forward, _jax_variables  # noqa: E402
from test_torch_train_step import check_train_step  # noqa: E402

REL_TOL = 1e-5
FIXTURES = Path(__file__).parent / "fixtures"
# (n_fft, hop, win, pad_mode), as chip_smoke.py phase 16 runs them
GEOMETRIES = cuda_stft.GEOMETRIES
IDS = [f"{n}-{h}-{w}-{p}" for n, h, w, p in GEOMETRIES]
# the kernel of each geometry: (forward, inverse)
ROUTES = {
    (400, 100, 400, "reflect"): ("stft_mag", "istft_polar"),
    (320, 160, 320, "reflect"): ("stft_mag", "istft_polar"),
    (400, 160, 400, "reflect"): ("stft_mag", "istft_dft"),
    (512, 100, 400, "reflect"): ("stft_mag", "istft_dft"),
    (512, 100, 512, "reflect"): ("stft_mag", "istft_dft"),
    (4096, 1024, 4096, "reflect"): ("stft_dft", "istft_dft"),
    (512, 128, 512, "constant"): ("stft_mag", "istft_polar"),
    (384, 96, 384, "reflect"): ("stft_mag", "istft_polar"),
    (450, 100, 450, "reflect"): ("stft_mag", "istft_dft"),
    (450, 100, 450, "edge"): ("stft_mag", "istft_dft"),
    (512, 128, 512, "reflect"): ("stft_mag", "istft_polar"),  # the repo's configs
}


@pytest.fixture(autouse=True)
def _two_threads():
    torch.set_num_threads(2)


def _cfgs(geom):
    n_fft, hop, win, pad_mode = geom
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=win, pad_mode=pad_mode)
    return STFTConfig(**kw), JConfig(**kw)


def _signal(geom, rng, batch=2):
    """A batch long enough for a few 64-frame tiles at small n_fft, and
    for 16 frames at n_fft 4096."""
    n = 40000 if geom[0] > 2048 else 9000
    return rng.standard_normal((1 if geom[0] > 2048 else batch, n)).astype(np.float32)


def _polar(geom, rng, n_frames, batch=2):
    f = geom[0] // 2 + 1
    mag = rng.random((batch, f, n_frames)).astype(np.float32)
    phase = (rng.random((batch, f, n_frames)) * 2 * np.pi - np.pi).astype(np.float32)
    return mag, phase


# ---------------------------------------------------------------------------
# The port's plain versions against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
def test_stft_matches_jax(geom, rng):
    """``stft_mag_plain`` against ``pallas_stft(return_mag=True)`` in
    interpret mode where the hop divides n_fft, else the JAX matmul path."""
    from jax.experimental.pallas import tpu as pltpu

    cfg, jcfg = _cfgs(geom)
    x = _signal(geom, rng)
    got = [t.numpy() for t in cuda_stft.stft_mag_plain(torch.from_numpy(x), cfg)]
    if cfg.n_fft % cfg.hop_length == 0:
        with pltpu.force_tpu_interpret_mode():
            ref = [np.asarray(t) for t in pallas_stft(jnp.asarray(x), jcfg, return_mag=True)]
    else:
        re, im = (np.asarray(t) for t in j_stft(jnp.asarray(x), jcfg))
        ref = [re, im, np.sqrt(re * re + im * im)]
    for a, b in zip(got, ref):
        assert a.shape == b.shape == (x.shape[0], cfg.num_bins, cfg.num_frames(x.shape[1]))
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=0)


@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
def test_istft_matches_jax(geom, rng):
    """``istft_polar_plain`` against ``pallas_istft(polar=True)`` in
    interpret mode where the hop divides n_fft, else the JAX matmul path;
    at the implied length and at a longer one (the zero tail)."""
    from jax.experimental.pallas import tpu as pltpu

    cfg, jcfg = _cfgs(geom)
    n_frames = 16 if geom[0] > 2048 else 70
    mag, phase = _polar(geom, rng, n_frames)
    for length in ((n_frames - 1) * cfg.hop_length, n_frames * cfg.hop_length + 37):
        got = cuda_stft.istft_polar_plain(torch.from_numpy(mag), torch.from_numpy(phase), cfg,
                                          length=length).numpy()
        if cfg.n_fft % cfg.hop_length == 0:
            with pltpu.force_tpu_interpret_mode():
                ref = np.asarray(pallas_istft(jnp.asarray(mag), jnp.asarray(phase), jcfg,
                                              length=length, polar=True))
        else:
            ref = np.asarray(j_reconstruct(jnp.asarray(mag), jnp.asarray(phase), jcfg,
                                           length=length))
        assert got.shape == ref.shape == (2, length)
        np.testing.assert_allclose(got, ref, atol=2e-5 * max(1.0, np.abs(ref).max()), rtol=0)


# ---------------------------------------------------------------------------
# A numpy model of K1g and K3g
# ---------------------------------------------------------------------------


def _k1g_source_index(cfg, length, n_frames, k_pad, pad):
    """K1g's gather: for frame f and sample n of the padded depth, the
    index into the row (``pad`` samples a side left to pad) and whether it
    is read (else zero), as ``stft_dft.cu``'s ``load`` computes them."""
    f = np.arange(-(-n_frames // 64) * 64)[:, None]  # whole frame tiles
    n = np.arange(k_pad)[None, :]
    j = f * cfg.hop_length + n - pad
    read = (f < n_frames) & (n < cfg.n_fft)
    reflect = cfg.pad_mode == "reflect"
    read &= reflect | ((j >= 0) & (j < length))
    j = np.where(j < 0, -j, np.where(j >= length, 2 * (length - 1) - j, j))
    return j, read


def k1g_model(x: np.ndarray, cfg: STFTConfig):
    """K1g in numpy: the gathered frames of each 64-frame tile times each
    column tile of ``dft_tiles`` (float64 sums), then the bins-first store
    of the tiles' rows and columns inside [F, N]. Rows the CUDA impl pads
    first (``_pads_first``) are padded here too, and gathered unpadded."""
    b, length = x.shape
    n_frames, f = cfg.num_frames(length), cfg.num_bins
    pad = cfg.n_fft // 2 if cfg.center else 0
    if cuda_stft._pads_first(cfg, length):
        x = center_pad(torch.from_numpy(x), cfg).numpy()
        length, pad = x.shape[1], 0
    bins, depth = cuda_stft.DFT_BLOCK_BINS, cuda_stft.DFT_DEPTH
    k_pad = -(-cfg.n_fft // depth) * depth
    tiles = cuda_stft.dft_tiles(cfg).reshape(-1, k_pad, 2, bins)
    j, read = _k1g_source_index(cfg, length, n_frames, k_pad, pad)
    assert ((j >= 0) & (j < length))[read].all()
    out = np.zeros((3, b, len(tiles) * bins, j.shape[0]))
    for row in range(b):
        a = np.where(read, x[row][np.clip(j, 0, length - 1)], 0.0)
        for bt, tile in enumerate(tiles):
            re, im = a @ tile[:, 0].astype(np.float64), a @ tile[:, 1].astype(np.float64)
            cols = slice(bt * bins, (bt + 1) * bins)
            out[0, row, cols], out[1, row, cols] = re.T, im.T
            out[2, row, cols] = np.sqrt(re * re + im * im).T
    return out[:, :, :f, :n_frames]


def k3g_frame_range(s: int, cfg: STFTConfig, n_frames: int) -> range:
    """The frames K3g's overlap-add sums for overlap-added sample ``s``
    (``istft_dft.cu``'s ``lo`` and ``hi``)."""
    hi = min(s // cfg.hop_length, n_frames - 1)
    lo = (s - cfg.n_fft) // cfg.hop_length + 1 if s >= cfg.n_fft else 0
    return range(lo, hi + 1)


def k3g_model(mag, phase, cfg: STFTConfig, length):
    """K3g in numpy: polar recombine, each column tile of ``idft_tiles``
    (float64 sums) into the frames scratch, then the gather overlap-add over
    ``k3g_frame_range``, the window-sum divide and the crop."""
    b, f, n_frames = mag.shape
    samples, depth = cuda_stft.IDFT_BLOCK_SAMPLES, cuda_stft.IDFT_DEPTH
    k_pad = -(-f // depth) * depth
    tiles = cuda_stft.idft_tiles(cfg).reshape(-1, k_pad, 2, samples).astype(np.float64)
    re = np.zeros((b, k_pad, n_frames))
    im = np.zeros((b, k_pad, n_frames))
    re[:, :f] = mag * np.cos(phase.astype(np.float64))
    im[:, :f] = mag * np.sin(phase.astype(np.float64))
    frames = np.concatenate([np.swapaxes(re, 1, 2) @ t[:, 0] + np.swapaxes(im, 1, 2) @ t[:, 1]
                             for t in tiles], axis=-1)[..., :cfg.n_fft]
    offset, n_out = istft_output_span(cfg, n_frames, length)
    denom = window_sumsquare_denominator(cfg, n_frames)
    ola_len = cfg.n_fft + (n_frames - 1) * cfg.hop_length
    y = np.zeros((b, n_out))
    for j in range(n_out):
        s = j + offset
        if s < ola_len:
            ts = k3g_frame_range(s, cfg, n_frames)
            y[:, j] = sum(frames[:, t, s - t * cfg.hop_length] for t in ts) / denom[s]
    return y


@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
def test_k1g_model_matches_plain(geom, rng):
    """Three lengths: several frame tiles, one shorter than a tile, and one
    just over n_fft/2 + 1 samples, where the reflection of both edges
    reaches across the whole row (n_fft/2 > hop at every geometry here)."""
    cfg, _ = _cfgs(geom)
    for length in (_signal(geom, rng).shape[1], 3 * cfg.n_fft, cfg.n_fft // 2 + 1):
        x = rng.standard_normal((2, length)).astype(np.float32)
        got = k1g_model(x, cfg)
        ref = [t.numpy() for t in cuda_stft.stft_mag_plain(torch.from_numpy(x), cfg)]
        scale = np.abs(ref[2]).max()
        for a, r in zip(got, ref):
            assert a.shape == r.shape
            assert np.abs(a - r).max() < REL_TOL * scale


def test_k1g_frame_zero_is_symmetric_under_reflect(rng):
    """Under reflect padding frame 0 is x[|n - n_fft/2|], symmetric about
    its center, so its spectrum is real up to the sign (-1)^k: its im is
    rounding noise, in the model and in the plain version alike (the root of
    the magnitude head's near-tie at 400/100, CHANGES.md)."""
    cfg, _ = _cfgs((400, 100, 400, "reflect"))
    x = rng.standard_normal((1, 4000)).astype(np.float32)
    k_pad = -(-cfg.n_fft // cuda_stft.DFT_DEPTH) * cuda_stft.DFT_DEPTH
    j, read = _k1g_source_index(cfg, 4000, cfg.num_frames(4000), k_pad, cfg.n_fft // 2)
    np.testing.assert_array_equal(j[0, :400], np.abs(np.arange(400) - 200))
    assert read[0, :400].all() and not read[0, 400:].any()
    _, im, mag = (t.numpy() for t in cuda_stft.stft_mag_plain(torch.from_numpy(x), cfg))
    assert np.abs(im[0, :, 0]).max() < 1e-5 * mag.max()
    assert np.abs(k1g_model(x, cfg)[1][0, :, 0]).max() < 1e-12 * mag.max()


@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
def test_k3g_model_matches_plain(geom, rng):
    cfg, _ = _cfgs(geom)
    n_frames = 16 if geom[0] > 2048 else 70
    mag, phase = _polar(geom, rng, n_frames)
    for length in ((n_frames - 1) * cfg.hop_length, n_frames * cfg.hop_length + 37):
        got = k3g_model(mag, phase, cfg, length)
        ref = cuda_stft.istft_polar_plain(torch.from_numpy(mag), torch.from_numpy(phase), cfg,
                                          length=length).numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() < REL_TOL * np.abs(ref).max()


@pytest.mark.parametrize("n_fft,hop", [(400, 100), (400, 160), (320, 160), (512, 100),
                                       (4096, 1024), (300, 400)])
def test_k3g_frame_ranges_cover_each_sample(n_fft, hop):
    """Each overlap-added sample sums exactly the frames that cover it, at
    most ceil(n_fft / hop) of them; with hop > n_fft the gaps sum none."""
    cfg = STFTConfig(n_fft=n_fft, hop_length=hop, win_length=n_fft)
    n_frames = 9
    for s in range(n_fft + (n_frames - 1) * hop):
        want = [t for t in range(n_frames) if t * hop <= s < t * hop + n_fft]
        got = list(k3g_frame_range(s, cfg, n_frames))
        assert got == want, s
        assert len(got) <= -(-n_fft // hop)


@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
def test_dft_tiles_hold_the_plain_matrices(geom):
    """The column tiles hold ``window_dft`` and ``inv_window_dft`` exactly,
    zero in their padding; a window shorter than n_fft stays zero-padded."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import (
        inv_window_dft,
        window_dft,
    )

    cfg, _ = _cfgs(geom)
    f, n = cfg.num_bins, cfg.n_fft
    k_pad = -(-n // cuda_stft.DFT_DEPTH) * cuda_stft.DFT_DEPTH
    t = cuda_stft.dft_tiles(cfg).reshape(-1, k_pad, 2, cuda_stft.DFT_BLOCK_BINS)
    full = np.concatenate(list(t), axis=-1)  # [k_pad, 2, tiles * bins]
    np.testing.assert_array_equal(full[:n, 0, :f], window_dft(cfg)[:, :f])
    np.testing.assert_array_equal(full[:n, 1, :f], window_dft(cfg)[:, f:])
    assert not full[n:].any() and not full[:, :, f:].any()
    k_pad = -(-f // cuda_stft.IDFT_DEPTH) * cuda_stft.IDFT_DEPTH
    t = cuda_stft.idft_tiles(cfg).reshape(-1, k_pad, 2, cuda_stft.IDFT_BLOCK_SAMPLES)
    full = np.concatenate(list(t), axis=-1)
    wa, wb = inv_window_dft(cfg)
    np.testing.assert_array_equal(full[:f, 0, :n], wa)
    np.testing.assert_array_equal(full[:f, 1, :n], wb)
    assert not full[f:].any() and not full[:, :, n:].any()
    if cfg.win_length < n:  # DCCRN: the window's zero ends zero whole rows
        lpad = (n - cfg.win_length) // 2
        assert not window_dft(cfg)[:lpad].any() and not wa[:, :lpad].any()


@pytest.mark.parametrize("source,tile", [
    ("stft_dft.cu", (cuda_stft.DFT_BLOCK_BINS, cuda_stft.DFT_DEPTH)),
    ("istft_dft.cu", (cuda_stft.IDFT_BLOCK_SAMPLES, cuda_stft.IDFT_DEPTH)),
])
def test_tile_layout_matches_the_sources(source, tile):
    """The wrapper cuts the matrices into the column tiles the kernels
    read: its width and depth are the source's ``BN`` and ``BK`` (the C
    entry refuses a launch with any other)."""
    import re

    text = (kernels.CSRC / source).read_text()
    consts = {m[1]: int(m[2]) for m in re.finditer(r"constexpr int (BN|BK) = (\d+);", text)}
    assert (consts["BN"], consts["BK"]) == tile
    assert re.search(r"if \(tile_\w+ != BN \|\| tile_depth != BK\) return", text)


@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
def test_flop_formulas_follow_the_geometry(geom, rng):
    """``tools.flops``' formulas for the two STFT ops count the DFT of the
    call's own geometry, 2 frames n_fft 2F (the JAX roofline's DSP count),
    whichever kernel the route picks."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools import flops

    cfg, _ = _cfgs(geom)
    x = torch.from_numpy(_signal(geom, rng))
    n = cfg.num_frames(x.shape[1])
    want = flops.stft_flops(x.shape[0], n, cfg.n_fft)
    assert want == 2.0 * x.shape[0] * n * cfg.n_fft * 2 * cfg.num_bins
    assert flops.torch_program_flops(cuda_stft.stft_mag, x, cfg) == want
    mag = torch.rand(x.shape[0], cfg.num_bins, n)
    assert flops.torch_program_flops(cuda_stft.istft_polar, mag, mag, cfg) == want


# ---------------------------------------------------------------------------
# The route of each geometry, through the CUDA impls
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _recorded_launches(monkeypatch):
    """The CUDA impls on CPU tensors: ``torch.cuda.device`` made a no-op
    and ``kernels.launch`` recording ``(name, args)`` instead of launching."""
    calls = []
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(kernels, "launch", lambda name, *a: calls.append((name, a)))
    yield calls


@pytest.mark.parametrize("geom", list(ROUTES), ids=[f"{n}-{h}-{w}-{p}" for n, h, w, p in ROUTES])
def test_route_of_each_geometry(geom, monkeypatch):
    """``route`` names the kernel; the CUDA impls launch it once, with the
    frames, padding and output span of the config (and K1's and K3's radix
    plan)."""
    cfg, _ = _cfgs(geom)
    fwd, inv = ROUTES[geom]
    assert cuda_stft.route(cfg, inverse=False)[0] == fwd
    assert cuda_stft.route(cfg, inverse=True)[0] == inv
    x = torch.zeros(3, 5000 if cfg.n_fft <= 2048 else 9000)
    n_frames = cfg.num_frames(x.shape[1])
    mag = torch.zeros(3, cfg.num_bins, n_frames)
    with _recorded_launches(monkeypatch) as calls:
        cuda_stft._stft_cuda(x, *cuda_stft._cfg_args(cfg))
        cuda_stft._istft_cuda(mag, mag, *cuda_stft._cfg_args(cfg), 4321)
    assert [c[0] for c in calls] == [fwd, inv]
    (_, a1), (_, a3) = calls
    pad = cfg.n_fft // 2
    length, fused = x.shape[1], pad
    if cuda_stft._pads_first(cfg, length):  # padded first, launched with no padding
        length, fused = length + 2 * pad, 0
    if fwd == "stft_dft":  # batch, length, pad, reflect, n_frames, n_fft, hop, tile layout
        assert a1[5:] == (3, length, fused, int(cfg.pad_mode == "reflect"), n_frames,
                          cfg.n_fft, cfg.hop_length, cuda_stft.DFT_BLOCK_BINS,
                          cuda_stft.DFT_DEPTH)
    else:  # batch, length, pad, reflect, n_frames, n_fft, hop, tile, radix plan
        assert a1[5:] == (3, length, fused, int(cfg.pad_mode == "reflect"), n_frames,
                          cfg.n_fft, cfg.hop_length, cuda_stft.kernel_tile(cfg, inverse=False),
                          cuda_stft.pack_radices(cuda_stft.fft_stages(cfg.n_fft // 2)))
    if inv == "istft_dft":  # batch, n_frames, n_fft, hop, offset, out_samples, tile layout
        assert a3[6:] == (3, n_frames, cfg.n_fft, cfg.hop_length, pad, 4321,
                          cuda_stft.IDFT_BLOCK_SAMPLES, cuda_stft.IDFT_DEPTH)
    else:
        assert a3[5:] == (3, n_frames, cfg.n_fft, cfg.hop_length, pad, 4321,
                          cuda_stft.kernel_tile(cfg, inverse=True),
                          cuda_stft.pack_radices(cuda_stft.fft_stages(cfg.n_fft // 2)))


def test_routes_refuse_what_no_kernel_takes(monkeypatch):
    """What remains refused, before a launch: a pad mode numpy does not
    have, more rows than one launch holds (the grid's y for K1 and K3, which
    take 400/100 since the mixed radices, its z for K1g and K3g). A signal
    too short for one reflection, once refused as the plain version refused
    it, is now padded as ``jnp.pad`` pads it (``test_torch_stft.py``)."""
    monkeypatch.setattr(kernels, "uses_kernel", lambda t: True)
    monkeypatch.setattr(kernels, "launch", lambda *a: pytest.fail("launched"))
    with pytest.raises(ValueError, match="pad_mode 'replicate'"):
        cuda_stft.stft_mag(torch.zeros(1, 4000), STFTConfig(pad_mode="replicate"))
    cfg = STFTConfig(n_fft=400, hop_length=100, win_length=400)
    assert cuda_stft.stft_mag(torch.zeros(1, 200), cfg)[0].shape == (1, 201, 3)
    dft_cfg = STFTConfig(n_fft=398, hop_length=100, win_length=398)  # 199: K1g and K3g
    for c, f in ((dft_cfg, 200), (cfg, 201)):
        with pytest.raises(ValueError, match="rows a launch"):
            cuda_stft.stft_mag(torch.zeros(cuda_stft.MAX_BATCH + 1, 500), c)
        m = torch.zeros(cuda_stft.MAX_BATCH + 1, f, 2)
        with pytest.raises(ValueError, match="rows a launch"):
            cuda_stft.istft_polar(m, m, c)
    with pytest.raises(ValueError, match="bins"):
        cuda_stft.istft_polar(torch.zeros(1, 257, 2), torch.zeros(1, 257, 2), cfg)


# ---------------------------------------------------------------------------
# The enhancer, a train step and a D = 48 model at 400/100/400
# ---------------------------------------------------------------------------

AUDIO_400 = {"n_fft": 400, "hop_length": 100, "win_length": 400}


def _fixture_pair(name, f_bins):
    path = FIXTURES / name
    jm = JHybridViT(**TINY)
    template = jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a, train=False),
                              jnp.zeros((1, f_bins, 64, 1), jnp.float32))
    return jm, j_load_model_weights(path, template), load_model_weights(path, HybridViT(**TINY))


def _clip(rng, n=16000):
    t = np.arange(n) / 16000
    return (0.4 * np.sin(2 * np.pi * rng.uniform(150, 300) * t)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("io_dtype", ["float32", "int16"])
def test_enhancer_at_400_100_matches_jax(io_dtype, rng):
    """The mask head (the serving recipe) on the trained mask fixture,
    F = 201, with and without the patch mask: within 5e-5, or 1 LSB for
    PCM16."""
    jm, jv, tm = _fixture_pair("tiny_denoiser_mask", 201)
    cfg = {"audio": AUDIO_400, "model": {"output_mode": "mask"}}
    wavs = [_clip(rng, n) for n in (16000, 9000)]
    tol = 5e-5 if io_dtype == "float32" else 1.0 / 32767 + 1e-6
    for masked in (False, True):
        kw = dict(io_dtype=io_dtype, mask_padding=masked)
        te = AudioEnhancer(tm, cfg, device="cpu", **kw)
        assert te.stft_cfg == STFTConfig(n_fft=400, hop_length=100, win_length=400)
        ours = te.enhance_batch(wavs)
        ref = JAudioEnhancer(jm, jv, cfg, **kw).enhance_batch(wavs)
        for a, b in zip(ours, ref):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=tol, rtol=0)


def test_magnitude_head_near_tie_at_400_100(rng):
    """The magnitude head at 400/100 on a near-tie: its output does not
    scale with the noisy magnitude, so a bin whose noisy |X| is at rounding
    level passes the noisy phase's rounding, atan2 of two near-zero values,
    into the waveform. The two packages' STFTs of the enhancer's input agree
    to 1e-5, yet their noisy phases differ most in frame 0, whose im is
    rounding noise under reflect padding, at a bin with |X| under 1e-3 of
    the peak; the waveforms differ most in the samples that frame covers and
    agree elsewhere as the mask head does."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import stft

    cfg, jcfg = _cfgs((400, 100, 400, "reflect"))
    x = np.zeros((1, 25500), np.float32)  # the 256-frame bucket
    x[0, :16000] = 0.3 * rng.standard_normal(16000)
    x /= np.abs(x).max()
    rt, it = (t.numpy()[0] for t in stft(torch.from_numpy(x), cfg))
    rj, ij = (np.asarray(t)[0] for t in j_stft(jnp.asarray(x), jcfg))
    mag = np.sqrt(rj * rj + ij * ij)
    assert max(np.abs(rt - rj).max(), np.abs(it - ij).max()) < 1e-5
    gap = np.abs(np.exp(1j * np.arctan2(it, rt)) - np.exp(1j * np.arctan2(ij, rj)))
    k, f = np.unravel_index(gap.argmax(), gap.shape)
    assert f == 0 and mag[k, f] < 1e-3 * mag.max() and gap[k, f] > 1e-3
    assert np.abs(ij[:, 0]).max() < 1e-5 * mag.max()

    jm, jv, tm = _fixture_pair("tiny_denoiser_mask", 201)
    cfg = {"audio": AUDIO_400, "model": {"output_mode": "magnitude"}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # magnitude head at blend 1.0
        ref = JAudioEnhancer(jm, jv, cfg).enhance(x[0, :16000])
        ours = AudioEnhancer(tm, cfg, device="cpu").enhance(x[0, :16000])
    diff = np.abs(ours - ref)
    assert diff[:200].max() > 2e-5  # frame 0 covers samples [0, 200)
    assert diff[200:].max() < 2e-5


def test_train_step_at_400_100_matches_jax(rng):
    """The recipe's step (mask output, patch mask, PCM16) with the JAX
    side's fused attention, at 400/100/400: loss 1e-5, gradients 1e-3 /
    5e-3."""
    check_train_step("resize", "mask", True, "learned_1d", True, True, rng,
                     stft_kw=AUDIO_400)


@pytest.mark.parametrize("masked", [False, True])
def test_head_dim_48_model_matches_jax(masked, rng):
    """embed_dim 96 with 2 heads (D = 48) at 2 layers: the port's model
    (on a card, K2 at its 64 instance, zero-padded) against the JAX model,
    1e-4."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu.models.components import (
        patch_validity_mask as j_patch_validity_mask,
    )

    kw = dict(SMALL, embed_dim=96, num_heads=2, num_layers=2, pos_embed_type="factored_2d")
    x = rng.random((2, 201, 64, 1)).astype(np.float32)
    jm = JHybridViT(**kw, use_pallas_attention=masked)
    v = _jax_variables(jm, x, rng)
    mask = None
    if masked:
        mask = np.asarray(j_patch_validity_mask(jnp.asarray([6300, 3700]), 201, 64, 100))
    ref = _jax_forward(jm, v, x, mask)
    tm = HybridViT(**kw).eval()
    tm.load_state_dict(flax_to_state_dict(v), strict=True)
    with torch.inference_mode():
        out = tm(torch.from_numpy(x), mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# K2 at any head dim up to 128
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [24, 48, 80, 96, 112, 192, 200, 256])
def test_padded_attention_equals_unpadded(d):
    """What the CUDA impls do, on the plain version: q, k, v (and, in the
    backward, the output's gradient) zero-padded to the next instance, the
    caller's scale, the result cropped; against the plain version at D,
    under a mask with a fully masked row."""
    g = torch.Generator().manual_seed(d)
    b, h, n = 2, 3, 40
    q, k, v, dout = (torch.randn(b, h, n, d, generator=g) for _ in range(4))
    mask = torch.rand(b, n, generator=g) > 0.3
    mask[1] = False
    dp = cuda_attention.kernel_head_dim(d)
    assert dp == {24: 32, 48: 64, 192: 256, 200: 256, 256: 256}.get(d, 128)
    pq, pk, pv, pdo = (cuda_attention._pad_head_dim(t, dp) for t in (q, k, v, dout))
    assert pq.shape[-1] == dp and pq.is_contiguous() and not pq[..., d:].any()
    scale = d ** -0.5
    out = cuda_attention.attention_plain(q, k, v, scale=scale, mask=mask)
    pout = cuda_attention.attention_plain(pq, pk, pv, scale=scale, mask=mask)
    assert not pout[..., d:].any()
    torch.testing.assert_close(pout[..., :d], out, atol=1e-6, rtol=0)
    grads = cuda_attention.attention_bwd_plain(q, k, v, dout, scale=scale, mask=mask)
    pgrads = cuda_attention.attention_bwd_plain(pq, pk, pv, pdo, scale=scale, mask=mask)
    for a, p in zip(grads, pgrads):
        assert not p[..., d:].any()
        torch.testing.assert_close(p[..., :d], a, atol=1e-6, rtol=0)


@pytest.mark.parametrize("d", [48, 96, 128, 129, 192, 256])
def test_attention_kernel_pads_or_refuses(d, monkeypatch):
    """The CUDA impls launch the padded instance and return D columns;
    above 128, once refused, the sliced instance at the next multiple of
    128 (129 and 192 at 256)."""
    q = torch.randn(1, 2, 8, d)
    with _recorded_launches(monkeypatch) as calls:
        out, lse = cuda_attention._forward_kernel(q, q, q, None, 0.1, True)
        grads = cuda_attention._backward_kernel(q, q, q, out, lse, q, None, 0.1)
    dp = cuda_attention.kernel_head_dim(d)
    assert dp == {48: 64, 96: 128, 128: 128}.get(d, 256)
    assert [(c[0], c[1][9]) for c in calls[:1]] == [("attention_fwd", dp)]
    assert [(c[0], c[1][14]) for c in calls[1:]] == [("attention_bwd", dp)]
    assert out.shape == q.shape and out.is_contiguous() and lse.shape == (2, 8)
    assert all(t.shape == q.shape and t.is_contiguous() for t in grads)


def sliced_attention_model(q, k, v, dout, scale, mask, slice_cols=cuda_attention.SLICE):
    """The sliced instance's schedule in float64, after the wrapper's zero
    padding to whole slices: for each output slice z a block sums the logits
    (and, in the backward, dO V^T and Delta) over the slices in the order
    z + 1, ..., z, then writes its own slice of out, dq, dk and dv."""
    d = q.shape[-1]
    dp = cuda_attention.kernel_head_dim(d)
    q, k, v, dout = (cuda_attention._pad_head_dim(t.double(), dp) for t in (q, k, v, dout))
    ns = dp // slice_cols
    cols = [slice(z * slice_cols, (z + 1) * slice_cols) for z in range(ns)]
    outs = {name: torch.zeros_like(q) for name in ("out", "dq", "dk", "dv")}
    keep = None if mask is None else mask[:, None, None, :]
    for z in range(ns):
        order = [(z + 1 + i) % ns for i in range(ns)]
        assert order[-1] == z
        s = sum(q[..., cols[o]] @ k[..., cols[o]].transpose(-1, -2) for o in order) * scale
        dpt = sum(dout[..., cols[o]] @ v[..., cols[o]].transpose(-1, -2) for o in order)
        if keep is not None:
            s = s.masked_fill(~keep, -1e30)
        p = torch.softmax(s, dim=-1)
        out = p @ v
        delta = (dout * out).sum(-1, keepdim=True)
        ds = p * (dpt - delta)
        if keep is not None:
            ds = ds.masked_fill(~keep, 0.0)
        outs["out"][..., cols[z]] = p @ v[..., cols[z]]
        outs["dq"][..., cols[z]] = scale * ds @ k[..., cols[z]]
        outs["dk"][..., cols[z]] = scale * ds.transpose(-1, -2) @ q[..., cols[z]]
        outs["dv"][..., cols[z]] = p.transpose(-1, -2) @ dout[..., cols[z]]
    return {name: t[..., :d] for name, t in outs.items()}


@pytest.mark.parametrize("d", [129, 192, 256, 320])
def test_sliced_attention_model_matches_plain(d):
    """The sliced schedule against the same sums over all of D at once
    (one slice), both in float64, within 1e-12 of the largest value; and
    against the plain forward and backward at D, fp32, within 1e-5 (fp32
    sums of up to 384 products), under a mask with a fully masked row."""
    g = torch.Generator().manual_seed(d)
    b, h, n = 2, 2, 24
    q, k, v, dout = (torch.randn(b, h, n, d, generator=g) for _ in range(4))
    mask = torch.rand(b, n, generator=g) > 0.3
    mask[1] = False
    scale = d ** -0.5
    got = sliced_attention_model(q, k, v, dout, scale, mask)
    whole = sliced_attention_model(q, k, v, dout, scale, mask,
                                   slice_cols=cuda_attention.kernel_head_dim(d))
    for name, w in whole.items():
        torch.testing.assert_close(got[name], w, atol=1e-12 * float(w.abs().max()), rtol=0)
    ref = dict(zip(("dq", "dk", "dv"),
                   cuda_attention.attention_bwd_plain(q, k, v, dout, scale=scale, mask=mask)))
    ref["out"] = cuda_attention.attention_plain(q, k, v, scale=scale, mask=mask)
    for name, r in ref.items():
        assert got[name].shape == r.shape
        tol = 1e-5 * max(1.0, float(r.abs().max()))
        torch.testing.assert_close(got[name].float(), r, atol=tol, rtol=0, msg=name)


@pytest.mark.parametrize("embed_dim", [384, 512])
def test_head_dim_above_128_model_matches_jax(embed_dim, rng):
    """embed_dim 384 and 512 with 2 heads (D = 192 and 256) at 2 layers
    under a patch mask: the port's model (on a card, K2's sliced instance
    at 256) against the JAX model, 1e-4."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu.models.components import (
        patch_validity_mask as j_patch_validity_mask,
    )

    kw = dict(SMALL, embed_dim=embed_dim, num_heads=2, num_layers=2,
              pos_embed_type="factored_2d")
    assert cuda_attention.kernel_head_dim(embed_dim // 2) == 256
    x = rng.random((2, 201, 64, 1)).astype(np.float32)
    jm = JHybridViT(**kw, use_pallas_attention=True)
    v = _jax_variables(jm, x, rng)
    mask = np.asarray(j_patch_validity_mask(jnp.asarray([6300, 3700]), 201, 64, 100))
    ref = _jax_forward(jm, v, x, mask)
    tm = HybridViT(**kw).eval()
    tm.load_state_dict(flax_to_state_dict(v), strict=True)
    with torch.inference_mode():
        out = tm(torch.from_numpy(x), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)
