"""The optimizer's CUDA kernels, ``global_sq_norm`` and ``adam_update``
(``csrc/optimizer.cu``), against their plain versions (the per-tensor
loops) on the card.

Marked ``cuda``: each test skips where there is no CUDA device. Run without
the suite's conftest (it imports JAX, which the card's machine lacks):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_optimizer_cuda.py

Limits: p, m and v bit-equal to the loop's on the card where both clip by
the same norm or neither clips (the kernel rounds op by op as the loop's
ATen kernels do). Where each clips by its own norm, within 1e-6 of the
largest magnitude among all the tensors of p, of m or of v: the kernel
sums the squares in double, the loop in fp32 tensor by tensor, so the clip
factor differs in the last bits, and a moment that cancels over the steps
can be far smaller than its terms.
"""

import json
from pathlib import Path

import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
    create_hybrid_vit,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
    cuda_optimizer,
    kernels,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.optimizer import (
    Optimizer,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent
SIZES = [(1,), (3,), (5,), (4097,), (2**20 + 7,), (64, 33)]
STEPS = 3
HYPER = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def hvit28m_shapes() -> list:
    """The parameter shapes of the benchmark's 28M model, in order."""
    c = json.loads((ROOT / "portbench" / "configs" / "hvit28m.json").read_text())
    with torch.device("meta"):
        model = create_hybrid_vit({"model": c["model"], "audio": c["audio"]})
    return [tuple(p.shape) for p in model.parameters() if p.requires_grad]


def make_tensors(shapes, dev, seed, misaligned: bool):
    """fp32 tensors of ``shapes`` on ``dev``; with ``misaligned`` the last
    one is a view at an offset of one element (not 16-byte aligned)."""
    g = torch.Generator().manual_seed(seed)
    out = [torch.randn(s, generator=g).to(dev) for s in shapes]
    if misaligned:
        n = out[-1].numel()
        base = torch.randn(n + 1, generator=g).to(dev)
        out[-1] = base[1:].view(out[-1].shape)
    return out


def run(tables, dev, *, fused: bool, name: str, max_norm, shared_norm: bool, seed=1):
    """``STEPS`` clip + Adam(W) steps of the kernel (``fused``) or the loop
    from the same start on the same gradients; returns (p, m, v)."""
    params, mu, nu = (make_tensors(tables, dev, seed + k, misaligned=True) for k in range(3))
    nu = [v.abs() for v in nu]
    for step in range(1, STEPS + 1):
        grads = make_tensors(tables, dev, 100 * seed + step, misaligned=True)
        norm = None
        if max_norm is not None:
            norm = (cuda_optimizer.global_norm_plain(grads) if shared_norm or not fused
                    else cuda_optimizer.global_norm(grads))
        kw = dict(HYPER, adamw=name == "adamw", count=step, g_norm=norm, max_norm=max_norm)
        if fused:
            assert cuda_optimizer.adam_update(params, grads, mu, nu, **kw)
        else:
            cuda_optimizer.adam_update_plain(params, grads, mu, nu, **kw)
    torch.cuda.synchronize()
    return params, mu, nu


@pytest.mark.parametrize("tables", ["sizes", "hvit28m"])
@pytest.mark.parametrize("clip", ["engaged", "not_engaged", "none"])
@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_adam_update_matches_the_loop(tables, clip, name, dev):
    shapes = SIZES if tables == "sizes" else hvit28m_shapes()
    if tables == "hvit28m":
        assert len(shapes) == 110
    max_norm = {"engaged": 1.0, "not_engaged": 1e9, "none": None}[clip]
    before = kernels.KERNELS["adam_update"].launches
    loop = run(shapes, dev, fused=False, name=name, max_norm=max_norm, shared_norm=True)
    same = run(shapes, dev, fused=True, name=name, max_norm=max_norm, shared_norm=True)
    assert kernels.KERNELS["adam_update"].launches == before + STEPS
    for a, b in zip(same, loop):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    if max_norm is None:
        return
    own = run(shapes, dev, fused=True, name=name, max_norm=max_norm, shared_norm=False)
    for a, b in zip(own, loop):
        gap = max(float((x - y).abs().max()) for x, y in zip(a, b))
        assert gap <= 1e-6 * max(float(y.abs().max()) for y in b)


def test_global_sq_norm_is_deterministic_and_close(dev):
    """Two launches on the same gradients give the same bits; the norm is
    within 1e-6 of the loop's and 1e-7 of a float64 sum. A table of more
    than ``NORM_MAX`` tensors is split over launches that finalize once."""
    grads = make_tensors(hvit28m_shapes(), dev, 7, misaligned=True)
    before = kernels.KERNELS["global_sq_norm"].launches
    a, b = cuda_optimizer.global_norm(grads), cuda_optimizer.global_norm(grads)
    assert kernels.KERNELS["global_sq_norm"].launches == before + 2
    assert torch.equal(a, b) and a.shape == () and a.dtype == torch.float32
    exact = sum(float(torch.sum(g.double() ** 2)) for g in grads) ** 0.5
    assert abs(float(a) - float(cuda_optimizer.global_norm_plain(grads))) <= 1e-6 * exact
    assert abs(float(a) - exact) <= 1e-7 * exact
    many = make_tensors([(i % 7 + 1,) for i in range(cuda_optimizer.NORM_MAX + 300)], dev, 8,
                        misaligned=True)
    before = kernels.KERNELS["global_sq_norm"].launches
    n = cuda_optimizer.global_norm(many)
    assert kernels.KERNELS["global_sq_norm"].launches == before + 2
    exact = sum(float(torch.sum(g.double() ** 2)) for g in many) ** 0.5
    assert abs(float(n) - exact) <= 1e-7 * exact
    assert torch.equal(n, cuda_optimizer.global_norm(many))


def test_adam_update_splits_a_long_table(dev):
    """More than ``ADAM_MAX`` tensors: one launch per ``ADAM_MAX``, the same
    bits as the loop."""
    shapes = [(i % 9 + 1,) for i in range(cuda_optimizer.ADAM_MAX + 100)]
    loop = run(shapes, dev, fused=False, name="adamw", max_norm=1.0, shared_norm=True)
    before = kernels.KERNELS["adam_update"].launches
    fused = run(shapes, dev, fused=True, name="adamw", max_norm=1.0, shared_norm=True)
    assert kernels.KERNELS["adam_update"].launches == before + 2 * STEPS
    for a, b in zip(fused, loop):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def _optimizer(dev, seed=3, **kw):
    params = make_tensors(SIZES, dev, seed, misaligned=False)
    return params, Optimizer(params, "adamw", lr=1e-3, max_norm=1.0, **kw)


def test_optimizer_steps_take_the_kernels_and_resume(dev):
    """``Optimizer.step`` on CUDA tensors: one ``global_sq_norm`` and one
    ``adam_update`` launch a step, counted as ``optimizer.fused_steps``.
    Three steps equal two steps, a ``state_dict`` round trip into a new
    optimizer, and a third."""
    grads = [make_tensors(SIZES, dev, 50 + s, misaligned=False) for s in range(3)]
    params, opt = _optimizer(dev)
    kernels.reset_launch_counts()
    before = tracing.counters()
    opt.step(grads[0])
    opt.step(grads[1])
    after = tracing.counters()
    assert after.get("optimizer.fused_steps", 0) == before.get("optimizer.fused_steps", 0) + 2
    assert after.get("optimizer.loop_steps", 0) == before.get("optimizer.loop_steps", 0)
    assert kernels.KERNELS["adam_update"].launches == 2
    assert kernels.KERNELS["global_sq_norm"].launches == 2
    state = {k: [t.clone() for t in v] if isinstance(v, list) else v
             for k, v in opt.state_dict().items()}
    saved = [p.clone() for p in params]
    opt.step(grads[2])
    params2, opt2 = _optimizer(dev, seed=4)
    for p, s in zip(params2, saved):
        p.copy_(s)
    opt2.load_state_dict(state)
    opt2.step(grads[2])
    for a, b in ((params, params2), (opt.mu, opt2.mu), (opt.nu, opt2.nu)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_accumulation_applies_the_mean_through_the_kernel(dev):
    """``MultiSteps(2)``: the first micro-step launches nothing, the second
    one ``global_sq_norm`` (the mean's norm) and one ``adam_update``,
    within 1e-6 of the loop's chain on the mean."""
    grads = [make_tensors(SIZES, dev, 60 + s, misaligned=False) for s in range(2)]
    params, opt = _optimizer(dev, accum_steps=2)
    ref = [p.clone() for p in params]
    kernels.reset_launch_counts()
    assert not opt.step(grads[0])
    kernels.reset_launch_counts()
    assert opt.step(grads[1])
    assert kernels.KERNELS["global_sq_norm"].launches == 1
    assert kernels.KERNELS["adam_update"].launches == 1
    mean = [a + (b - a) / 2 for a, b in zip(*grads)]
    mu, nu = [torch.zeros_like(p) for p in ref], [torch.zeros_like(p) for p in ref]
    cuda_optimizer.adam_update_plain(ref, mean, mu, nu, **HYPER, adamw=True, count=1,
                                     g_norm=cuda_optimizer.global_norm_plain(mean), max_norm=1.0)
    gap = max(float((x - y).abs().max()) for x, y in zip(params, ref))
    assert gap <= 1e-6 * max(float(y.abs().max()) for y in ref)


def test_adam_update_takes_a_gradient_in_another_layout(dev):
    """A dense gradient laid out otherwise than its parameter (transposed,
    as cuDNN may hand back a weight's gradient) is copied to the
    parameter's layout: the same bits as the loop, which reads it as it is;
    the norm reads it in place."""
    shapes = [(64, 33), (5, 7)]
    outs = []
    for fused in (False, True):
        params, mu, nu = (make_tensors(shapes, dev, k, misaligned=False) for k in range(3))
        nu = [v.abs() for v in nu]
        grads = [t.t().contiguous().t() for t in make_tensors(shapes, dev, 9, misaligned=False)]
        assert not grads[0].is_contiguous()
        norm = (cuda_optimizer.global_norm if fused else cuda_optimizer.global_norm_plain)(grads)
        fn = cuda_optimizer.adam_update if fused else cuda_optimizer.adam_update_plain
        fn(params, grads, mu, nu, **HYPER, adamw=True, count=1, g_norm=norm, max_norm=1.0)
        outs.append((norm, params, mu, nu))
    (n0, *loop), (n1, *fused) = outs
    assert abs(float(n1) - float(n0)) <= 1e-6 * float(n0)
    for a, b in zip(fused, loop):
        gap = max(float((x - y).abs().max()) for x, y in zip(a, b))
        assert gap <= 1e-6 * max(float(y.abs().max()) for y in b)


def test_optimizer_kernels_refuse_what_they_do_not_take(dev):
    """fp64, a view with gaps (every other column) and a CPU tensor among
    CUDA ones are refused, never computed by the loop."""
    x = torch.randn(8, 4, device=dev)
    with pytest.raises(TypeError, match="float32"):
        cuda_optimizer.global_norm([x.double()])
    with pytest.raises(ValueError, match="dense"):
        cuda_optimizer.global_norm([x[:, ::2]])
    with pytest.raises(ValueError, match="tensors on"):
        cuda_optimizer.global_norm([x, x.cpu()])
    kw = dict(HYPER, adamw=True, count=1)
    d = x.double()
    with pytest.raises(TypeError, match="float32"):
        cuda_optimizer.adam_update([d], [d], [d], [d], **kw)
    t = x[:, ::2]
    with pytest.raises(ValueError, match="dense"):
        cuda_optimizer.adam_update([t], [t], [t], [t], **kw)
    with pytest.raises(ValueError, match="tensors on"):
        cuda_optimizer.adam_update([x], [x.cpu()], [x], [x], **kw)
