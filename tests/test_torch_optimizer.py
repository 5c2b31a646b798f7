"""The port's optimizer and epoch schedules against the JAX package's optax
chain on the CPU.

Adam, AdamW and SGD (with and without Nesterov momentum) behind the
global-norm clip, alone and inside ``MultiSteps``, take the same numpy
gradients as optax for 3 applied steps; parameters agree within 3e-6
(float32, the same formulas; Adam's bias correction 1 - b2^t cancels, and
optax's float32 power leaves it ~3e-5 off at t = 3, where the port's is
float64). Every schedule maps epoch -> lr as the JAX
one does (cosine ignores ``warmup_epochs``), within 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.training.optimizer import (
    chain_with_clip,
    create_optimizer,
    create_scheduler as j_create_scheduler,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.optimizer import (
    Optimizer,
    create_scheduler,
    global_norm,
)

torch.set_num_threads(2)

SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}


def _config(name, **kw):
    return {"training": {"optimizer": {"name": name, "lr": 0.05, "weight_decay": 0.1,
                                       "momentum": 0.9, **kw},
                         "gradient_clip_max_norm": 1.0}}


@pytest.mark.parametrize("name,kw,accum", [
    ("adam", {}, 1), ("adamw", {}, 1), ("sgd", {}, 1), ("sgd", {"nesterov": True}, 1),
    ("adamw", {}, 2), ("sgd", {}, 3)])
def test_optimizer_matches_optax(name, kw, accum, rng):
    config = _config(name, **kw)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    # gradient norms both above and below the clip's 1.0
    grads = [{k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}
             for scale in (2.0, 0.05, 1.5, 0.2, 3.0, 0.1, 0.7, 2.5, 0.01)][: 3 * accum]

    tx = chain_with_clip(create_optimizer(config), 1.0)
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)

    tp = [torch.from_numpy(params[k].copy()) for k in SHAPES]
    opt = Optimizer(tp, name=name, lr=0.05, weight_decay=0.1, momentum=0.9,
                    nesterov=kw.get("nesterov", False), max_norm=1.0, accum_steps=accum)
    for i, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        applied = opt.step([torch.from_numpy(g[k]) for k in SHAPES])
        assert applied == ((i + 1) % accum == 0)
        for k, t in zip(SHAPES, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), atol=3e-6, rtol=0)
    assert opt.count == 3


def test_clip_is_optax_global_norm_clip():
    """``g * max_norm / g_norm`` from ``g_norm >= max_norm`` on, no epsilon;
    below it the gradient passes untouched."""
    g = [torch.full((4,), 0.5)]  # norm 1.0: clipped (by a factor of exactly 1)
    assert float(global_norm(g)) == 1.0
    opt = Optimizer([torch.zeros(4)], "sgd", lr=1.0, momentum=None, max_norm=0.5)
    opt.step(g)
    np.testing.assert_allclose(opt.params[0].numpy(), -0.25 * np.ones(4), rtol=0, atol=1e-7)
    opt = Optimizer([torch.zeros(4)], "sgd", lr=1.0, momentum=None, max_norm=2.0)
    opt.step(g)
    np.testing.assert_array_equal(opt.params[0].numpy(), -0.5 * np.ones(4))


def test_multisteps_keeps_params_between_applied_steps():
    p = torch.ones(3)
    opt = Optimizer([p], "adamw", lr=0.1, accum_steps=3)
    assert not opt.step([torch.ones(3)]) and not opt.step([torch.ones(3)])
    assert torch.equal(p, torch.ones(3)) and opt.count == 0
    assert opt.step([torch.ones(3)]) and opt.count == 1 and not torch.equal(p, torch.ones(3))


def test_state_dict_round_trip(rng):
    params = [torch.from_numpy(rng.standard_normal(4).astype(np.float32)) for _ in range(2)]
    opt = Optimizer(params, "adamw", lr=0.01, accum_steps=2)
    for _ in range(3):
        opt.step([torch.randn(4) for _ in range(2)])
    other = Optimizer([p.clone() for p in params], "adamw", lr=0.5, accum_steps=2)
    other.load_state_dict(opt.state_dict())
    assert (other.lr, other.count, other.mini_step) == (0.01, 1, 1)
    for k in ("mu", "nu", "acc"):
        assert all(torch.equal(a, b) for a, b in zip(getattr(other, k), getattr(opt, k)))
    with pytest.raises(ValueError, match="optimizer state"):
        Optimizer(params, "sgd").load_state_dict(opt.state_dict())


@pytest.mark.parametrize("sched", [
    {"name": "none"}, {"name": "cosine", "warmup_epochs": 5, "min_lr": 1e-6},
    {"name": "warmup_cosine", "warmup_epochs": 3, "min_lr": 1e-5},
    {"name": "step", "step_size": 4, "gamma": 0.5},
    {"name": "plateau", "patience": 1, "factor": 0.5, "min_lr": 2e-5}])
def test_schedules_match_jax(sched):
    config = {"training": {"optimizer": {"lr": 1e-3}, "scheduler": sched, "num_epochs": 12}}
    ours, ref = create_scheduler(config), j_create_scheduler(config)
    val = [1.0, 0.9, 0.95, 0.97, 0.8, 0.85, 0.86, 0.87, 0.9, 0.7, 0.71, 0.72, 0.73, 0.74]
    for epoch, loss in enumerate(val):
        assert abs(ours(epoch, loss) - ref(epoch, loss)) <= 1e-12, epoch


def test_cosine_ignores_warmup():
    """The reference's quirk: only ``warmup_cosine`` warms up."""
    config = {"training": {"optimizer": {"lr": 1e-3}, "num_epochs": 10,
                           "scheduler": {"name": "cosine", "warmup_epochs": 5, "min_lr": 0.0}}}
    assert create_scheduler(config)(0) == 1e-3
    config["training"]["scheduler"]["name"] = "warmup_cosine"
    assert create_scheduler(config)(0) == pytest.approx(2e-4)
