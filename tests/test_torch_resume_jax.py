"""The port resumes training from a checkpoint of the JAX package's
``Trainer``, optax state included, on the CPU.

The JAX trainer takes one step and saves; the port's ``Trainer`` resumes
from that checkpoint, plain AdamW and inside ``MultiSteps(2)``. Resumed: the
weights, BatchNorm statistics, Adam's count and moments, the learning rate,
the accumulation position and gradients, exactly (after the same kernel
transposes as the weights), and the loop position (step, epoch + 1, best
loss). Then each side takes one more step on the same batch, the JAX one
under ``jax.enable_x64`` as in ``test_torch_train_step.py``:

* the gradient each applied (under ``MultiSteps(2)`` the clipped mean of the
  resumed accumulation and this step's), recovered from Adam's first moment
  (``(mu' - b1 mu) / (1 - b1)``), within 5e-3 of the model's largest and
  5e-2 of each leaf's own largest. These are wider than
  ``test_torch_train_step.py``'s (1e-3, 5e-3), whose weights and batch are
  kept fixed: on these, after a step, some float32 gradients are
  ill-conditioned and move from run to run with the CPU's summation order.
  Measured over three runs: the first conv's up to 1.85e-3 of the model's
  largest (6e-6 in another run), and the learned positional table's, a sum
  over the batch that cancels to ~1/16 of its rows' gradients, 0.9% of its
  own largest (the JAX package's own float32 step is 1.3% off its float64
  step there on the second batch alone). A resume that lost or misplaced
  any state would be off by the gradient's own size;
* the JAX step's new parameters against the port's AdamW from the resumed
  state applied to the JAX step's own gradient, within 5e-5 of the learning
  rate plus 2 ulp of the parameter (the JAX step rounds ``p + u`` from
  float64): optax keeps ``b1`` and ``b2`` as float32 hyperparameters, and its
  float32 ``1 - b2`` and ``1 - b2^t`` are ~1.3e-5 off the port's, which
  moves an Adam update by about that share (measured 2.2e-6 of the learning
  rate here; ``test_torch_optimizer.py`` holds the same arithmetic to optax
  at 3e-6 with a learning rate of 0.05);
* the same step count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.models import HybridViT as JHybridViT
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.parallel.mesh import make_mesh
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.training import Trainer as JTrainer
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.training.trainer import (
    make_step_fns as j_make_step_fns,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import HybridViT
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.optimizer import (
    Optimizer,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.trainer import (
    Trainer,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
    flax_to_state_dict,
    optax_state_to_port,
)
from test_torch_model import SMALL, _jax_variables
from test_torch_train_step import make_batch

torch.set_num_threads(2)

B1 = 0.9


def _config(accum: int) -> dict:
    return {"training": {"gradient_accumulation_steps": accum,
                         "optimizer": {"name": "adamw", "lr": 1e-3},
                         "logging": {"use_tensorboard": False}},
            "data": {"augmentation": {"enabled": False}}}


def _applied_grads(mu_after, mu_before):
    return [(a - B1 * b) / (1 - B1) for a, b in zip(mu_after, mu_before)]


@pytest.mark.parametrize("accum", [1, 2], ids=["adamw", "multisteps2"])
def test_port_resumes_a_jax_checkpoint(accum, rng, tmp_path):
    config = _config(accum)
    jm = JHybridViT(**SMALL)
    # the train-step tests' weights, drawn first as there (the JAX
    # initializer's give an fp32 step that is ill-conditioned against
    # float64, the JAX package's own fp32 step included)
    v = _jax_variables(jm, np.zeros((1, 257, 64, 1), np.float32), rng)
    b1, b2 = make_batch(rng, True), make_batch(rng, True)
    jtr = JTrainer(jm, config, [b1], mesh=make_mesh(data_parallel=1, devices=jax.devices()[:1]),
                   example_batch=b1, checkpoint_dir=tmp_path / "j", log_dir=tmp_path / "jl")
    jtr.state = jtr.state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, v["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]))
    jtr.state, _ = jtr.train_step(jtr.state, b1, jtr.rng)
    jtr.best_val_loss = 0.5
    jtr.save(tmp_path / "ck", 0)

    ptr = Trainer(HybridViT(**SMALL), config, [b2], None, device="cpu",
                  checkpoint_dir=tmp_path / "p", log_dir=tmp_path / "pl",
                  resume_from=tmp_path / "ck")
    names = [n for n, p in ptr.model.named_parameters() if p.requires_grad]
    before = jax.tree_util.tree_map(np.asarray, jax.device_get(jtr.state))
    want = optax_state_to_port(serialization.to_state_dict(before.opt_state), names)
    opt = ptr.optimizer
    assert (ptr.step, ptr.current_epoch, ptr.best_val_loss) == (1, 1, 0.5)
    assert (opt.count, opt.mini_step, opt.lr) == (want["count"], accum - 1, want["lr"])
    assert opt.count == (1 if accum == 1 else 0) and want["lr"] == pytest.approx(1e-3)
    for key in ("mu", "nu") + (("acc",) if accum > 1 else ()):
        for a, b in zip(getattr(opt, key), want[key]):
            assert torch.equal(a, b), key
    variables = flax_to_state_dict({"params": before.params, "batch_stats": before.batch_stats})
    for k, v in variables.items():
        assert torch.equal(ptr.model.state_dict()[k], v), k
    mu1 = [m.clone() for m in opt.mu]
    p1 = [p.detach().clone() for p in opt.params]

    # one more step on each side; the JAX one traced anew under x64 (the
    # trainer's own jitted step keeps its float32 trace)
    with jax.enable_x64(True):
        step, _ = j_make_step_fns(jm, jtr.optimizer, jtr.loss_cfg, jtr.stft_cfg, jtr.aug_cfg,
                                  augment=False)
        after, _ = step(before, b2, jtr.rng)
    after = jax.tree_util.tree_map(np.asarray, jax.device_get(after))
    ptr.train_epoch(ptr.current_epoch)
    got = optax_state_to_port(serialization.to_state_dict(after.opt_state), names)
    assert ptr.step == int(after.step) == 2
    assert opt.count == got["count"] == (2 if accum == 1 else 1) and opt.mini_step == 0

    ref_g = _applied_grads([m.double() for m in got["mu"]], [m.double() for m in mu1])
    port_g = _applied_grads([m.double() for m in opt.mu], [m.double() for m in mu1])
    scale = max(float(g.abs().max()) for g in ref_g)
    for n, a, b in zip(names, port_g, ref_g):
        err = float((a - b).abs().max())
        assert err <= 5e-3 * scale and err <= 5e-2 * float(b.abs().max()), n

    # the port's AdamW from the resumed state on the JAX step's own gradient
    ref_opt = Optimizer([p.clone() for p in p1], "adamw", lr=opt.lr, max_norm=None)
    ref_opt.load_state_dict(dict(want, mini_step=0, acc=None))
    ref_opt.step([g.float() for g in ref_g])
    new = flax_to_state_dict({"params": after.params, "batch_stats": after.batch_stats})
    for n, a in zip(names, ref_opt.params):
        b = new[n].float()
        unit = torch.maximum(a.abs(), b.abs())
        ulp = torch.nextafter(unit, torch.tensor(float("inf"))) - unit
        assert bool(((a - b).abs() <= 5e-5 * opt.lr + 2 * ulp).all()), n
