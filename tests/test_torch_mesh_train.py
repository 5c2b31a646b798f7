"""Multi-process training steps of the port against the JAX package's SPMD
step on a mesh of the conftest's virtual CPU devices.

The port's ranks are gloo processes started by ``parallel.launch``
(``torch_mesh_worker.py``), one per mesh device; the JAX step runs the same
global batch on a mesh of as many devices, from the same weights. As in
``test_torch_train_step.py``: dropouts 0 and SpecAugment off (JAX's random
streams are its own), the JAX step under ``jax.enable_x64``, gradients
captured by a pass-through optax transform, and the train-step limits:
loss components 1e-5 absolute (SI-SDR in dB 1e-4), the new BatchNorm
statistics 1e-5, every gradient element within 1e-3 of the model's largest
gradient and each leaf within 5e-3 of its own largest.

* Two data ranks, 2 rows each, against JAX on a 2-device data mesh: a full
  batch, and one where rank 1's rows are all invalid (a lockstep padding
  batch). The planted fault "each rank divides its loss by its own count and
  the ranks average" fails the second case: rank 1's terms are 0, so the
  average halves the loss and the gradient.
* BatchNorm: every rank ends with the same statistics, those of the global
  batch (every row, valid or not, as JAX's), not of its own rows.
* Tensor parallelism at 2 x 2 (data x model), heads split 2 + 2: the
  eval-mode forward against the port on one device and against JAX's TP
  mesh (``test_tp_sharded_forward_matches_replicated``'s 2e-5), and one
  step's gathered gradients against the port's single-device step and
  JAX's 2 x 2 TP step, at the train-step limits. The planted fault "TP
  without its all_reduce" (``reduce_from_group`` as identity) fails the
  forward by the other rank's partial sums.
* The ``Trainer``'s random streams at 2 x 2 with dropouts 0.5: the two data
  ranks draw different masks; the two model ranks of one data shard give
  the same train-mode output (dropout after the reduce, drop-path, the CNN's
  dropout drawn alike) and different tensor-parallel draws (dropout on their
  own heads). Its checkpoint is written by rank 0 alone, gathered, and a
  tensor-parallel resume reads it back to the same shards, as it reads a JAX
  checkpoint (optax state included); the unsharded copy (the audio samples'
  model) computes as the whole model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.data.augmentation import (
    SpecAugmentConfig as JSpecAugmentConfig,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.models import HybridViT as JHybridViT
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.ops.stft import STFTConfig as JSTFTConfig
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.parallel import (
    make_mesh as j_make_mesh,
    shard_variables,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.training.losses import (
    LossConfig as JLossConfig,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.training.optimizer import (
    chain_with_clip,
    create_optimizer,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.training.trainer import (
    TrainState,
    make_step_fns as j_make_step_fns,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.utils.checkpoint import (
    save_checkpoint as j_save_checkpoint,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.augmentation import (
    SpecAugmentConfig,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import HybridViT
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import STFTConfig
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.losses import LossConfig
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.trainer import (
    make_step_fns,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
    flax_to_state_dict,
)
from test_torch_model import SMALL, _jax_variables
from test_torch_train_step import _GRAD_CAPTURE
from torch_mesh_worker import Capture, run_job

torch.set_num_threads(2)

LEN = 63 * 128  # the 64-frame bucket
DP_MODEL = dict(SMALL, head_type="fullres_mask", head_channels=8, pos_embed_type="factored_2d")
DP_LOSS = dict(log_l1_weight=0.05, si_sdr_weight=0.01)
DP_STEP = dict(use_attention_mask=True, output_mode="mask")
TP_MODEL = dict(SMALL)
TP_LOSS = dict(log_l1_weight=0.05)
TP_STEP = dict(use_attention_mask=False, output_mode="magnitude")


def make_batch(rng, valid):
    """PCM16 rows of the 64-frame bucket, of random lengths; rows marked
    invalid keep their audio, as the loader's padding batch does."""
    n = len(valid)
    lengths = rng.integers(3000, LEN, n).astype(np.int32)
    clean = np.zeros((n, LEN), np.float32)
    noisy = np.zeros((n, LEN), np.float32)
    for i, m in enumerate(lengths):
        clean[i, :m] = 0.3 * np.sin(np.arange(m) * 0.03 * (i + 1))
        noisy[i, :m] = clean[i, :m] + 0.1 * rng.standard_normal(m)
    pcm = lambda x: np.clip(np.rint(x * 32768), -32768, 32767).astype(np.int16)  # noqa: E731
    return {"noisy_audio": pcm(noisy), "clean_audio": pcm(clean), "length": lengths,
            "valid": np.array(valid)}


def jax_steps(jm, variables, batches, loss_kw, jmesh, tensor_parallel=False, **kw):
    """The JAX step on ``jmesh`` from ``variables`` on each of ``batches``
    (one compiled step): ``(gradients and statistics, metrics)`` each."""
    out = []
    with jax.enable_x64(True):
        step, _ = j_make_step_fns(jm, _GRAD_CAPTURE, JLossConfig(**loss_kw), JSTFTConfig(),
                                  JSpecAugmentConfig(), augment=False, mesh=jmesh, **kw)
        for batch in batches:
            state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                               opt_state=_GRAD_CAPTURE.init(variables["params"]),
                               step=jnp.asarray(0, jnp.int32))
            if tensor_parallel:
                state = shard_variables(state, jmesh, use_tp=True)
            new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                jax.random.PRNGKey(0))
            tree = jax.tree_util.tree_map(np.asarray, {"params": new.opt_state,
                                                       "batch_stats": new.batch_stats})
            out.append((flax_to_state_dict(tree), {k: float(v) for k, v in metrics.items()}))
    return out


def port_step(model_kw, state, batch, loss_kw, **kw):
    """The port's step on one device: metrics, gradients, statistics."""
    m = HybridViT(**model_kw)
    m.load_state_dict(state)
    cap = Capture(list(m.parameters()))
    step, _ = make_step_fns(m, cap, LossConfig(**loss_kw), STFTConfig(), SpecAugmentConfig(),
                            augment=False, **kw)
    metrics = {k: float(v) for k, v in step({k: torch.from_numpy(v) for k, v in
                                             batch.items()}).items()}
    names = [n for n, _ in m.named_parameters()]
    stats = {k: v for k, v in m.state_dict().items() if "running" in k}
    return metrics, dict(zip(names, cap.grads)), stats


def check_step(rank_out, ref_metrics, ref):
    """One rank's step against a reference at the train-step limits."""
    metrics, grads, stats = rank_out["metrics"], rank_out["grads"], rank_out["stats"]
    assert set(metrics) == set(ref_metrics)
    for k, v in metrics.items():
        tol = 1e-4 if k == "si_sdr_db" else 1e-5
        assert abs(v - ref_metrics[k]) <= tol * (1 if k != "grad_norm" else max(1, v)), k
    scale = max(float(ref[n].abs().max()) for n in grads)
    for n, g in grads.items():
        err = float((g - ref[n].float()).abs().max())
        assert err <= 1e-3 * scale, n
        assert err <= 5e-3 * float(ref[n].abs().max()), n
    assert stats and set(stats) == {k for k in ref if "running" in k}
    for k, v in stats.items():
        assert float((v - ref[k].float()).abs().max()) <= 1e-5, k


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    rng = np.random.default_rng(11)
    jm = JHybridViT(**DP_MODEL)
    variables = _jax_variables(jm, np.zeros((1, 257, 64, 1), np.float32), rng)
    state = flax_to_state_dict(variables)
    batches = {"full": make_batch(rng, [True] * 4),
               "padding": make_batch(rng, [True, True, False, False])}
    cases = [{"kind": "step", "model": DP_MODEL, "state": state, "loss": DP_LOSS,
              "step": DP_STEP, "batch": b} for b in batches.values()]
    ranks = run_job({"cases": cases}, 2, 1, tmp_path_factory.mktemp("dp"))
    jmesh = j_make_mesh(data_parallel=2, devices=jax.devices()[:2])
    refs = dict(zip(batches, jax_steps(jm, variables, batches.values(), DP_LOSS, jmesh,
                                       **DP_STEP)))
    return {name: [r[i] for r in ranks] for i, name in enumerate(batches)}, refs, batches, state


@pytest.mark.parametrize("case", ["full", "padding"])
def test_two_data_ranks_step_matches_jax_mesh(dp_run, case):
    ranks, refs, _, _ = dp_run
    ref, ref_metrics = refs[case]
    for rank_out in ranks[case]:
        check_step(rank_out, ref_metrics, ref)
    a, b = ranks[case]
    assert a["metrics"] == b["metrics"]
    for n in a["grads"]:
        assert torch.equal(a["grads"][n], b["grads"][n]), n


def test_batchnorm_statistics_are_the_global_batches(dp_run):
    ranks, _, batches, state = dp_run
    batch = batches["padding"]
    _, _, global_stats = port_step(DP_MODEL, state, batch, DP_LOSS, **DP_STEP)
    _, _, own_stats = port_step(DP_MODEL, state, {k: v[:2] for k, v in batch.items()}, DP_LOSS,
                                **DP_STEP)
    a, b = ranks["padding"]
    for k, v in global_stats.items():
        assert torch.equal(a["stats"][k], b["stats"][k]), k
        assert float((a["stats"][k] - v).abs().max()) <= 1e-6, k
    assert max(float((a["stats"][k] - v).abs().max()) for k, v in own_stats.items()) > 1e-3


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    rng = np.random.default_rng(12)
    jm = JHybridViT(**TP_MODEL)
    variables = _jax_variables(jm, np.zeros((1, 257, 64, 1), np.float32), rng)
    state = flax_to_state_dict(variables)
    batch = make_batch(rng, [True, True, True, False])
    spec = rng.random((2, 257, 64, 1)).astype(np.float32)
    tmp = tmp_path_factory.mktemp("tp")
    # a checkpoint as the JAX trainer writes it: weights and the optax state
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    opt = chain_with_clip(create_optimizer({"optimizer": {"name": "adamw", "lr": 1e-3}}), 1.0)
    j_save_checkpoint(tmp / "jax_ck", {"params": params, "batch_stats": variables["batch_stats"],
                                       "opt_state": opt.init(params),
                                       "step": jnp.asarray(3, jnp.int32)}, epoch=0)
    drop_model = dict(TP_MODEL, dropout=0.5, attn_dropout=0.5, drop_path_rate=0.5)
    cases = [{"kind": "step", "model": TP_MODEL, "state": state, "loss": TP_LOSS,
              "step": TP_STEP, "batch": batch, "tensor_parallel": True, "spec": spec},
             {"kind": "dropout", "model": drop_model, "state": state, "spec": spec,
              "dir": str(tmp / "trainer"), "jax_checkpoint": str(tmp / "jax_ck")}]
    ranks = run_job({"cases": cases}, 2, 2, tmp)
    jmesh = j_make_mesh(data_parallel=2, model_parallel=2, devices=jax.devices()[:4])
    jforward = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        shard_variables(variables, jmesh, use_tp=True), jnp.asarray(spec))
    jref = jax_steps(jm, variables, [batch], TP_LOSS, jmesh, tensor_parallel=True,
                     **TP_STEP)[0]
    return ranks, np.asarray(jforward), jref, batch, spec, state, tmp


def test_tensor_parallel_forward_matches_one_device_and_jax(tp_run):
    ranks, jforward, _, _, spec, state, _ = tp_run
    m = HybridViT(**TP_MODEL)
    m.load_state_dict(state)
    with torch.no_grad():
        one = m.eval()(torch.from_numpy(spec))
    for r in ranks:
        out = r[0]["forward"]
        assert float((out - one).abs().max()) <= 2e-5
        np.testing.assert_allclose(out.numpy(), jforward, atol=2e-5, rtol=0)


def test_tensor_parallel_step_matches_one_device_and_jax(tp_run):
    ranks, _, (jgrads, jmetrics), batch, _, state, _ = tp_run
    metrics, grads, stats = port_step(TP_MODEL, state, batch, TP_LOSS, **TP_STEP)
    one = dict(grads, **stats)
    for r in ranks:
        check_step(r[0], metrics, one)
        check_step(r[0], jmetrics, jgrads)


def test_random_streams_by_rank_and_rank0_checkpoint(tp_run):
    ranks, _, _, _, spec, _, tmp = tp_run
    d = [r[1] for r in ranks]  # rank = 2 x data rank + model rank
    # model ranks of one data shard: the same output and default stream, their
    # own tensor-parallel stream
    for a, b in ((d[0], d[1]), (d[2], d[3])):
        assert torch.equal(a["out"], b["out"]) and torch.equal(a["default"], b["default"])
        assert not torch.equal(a["tp"], b["tp"])
    # data ranks: different masks
    assert not torch.equal(d[0]["out"], d[2]["out"])
    assert not torch.equal(d[0]["default"], d[2]["default"])
    saved = sorted(p.name for p in (tmp / "trainer").iterdir() if p.name.startswith("saved_by"))
    assert saved == ["saved_by_0"]
    _, _, _, _, _, state, _ = tp_run
    for r in d:  # every rank resumed its shards of the gathered checkpoint, and of a JAX one
        for k, v in r["gathered"].items():
            if not k.endswith("num_batches_tracked"):  # not in the JAX format
                assert torch.equal(r["resumed"][k], v), k
                assert torch.equal(r["from_jax"][k], state[k].float()), k
    full = HybridViT(**TP_MODEL)
    full.load_state_dict(d[0]["gathered"])  # whole weights, in the port's own shapes
    with torch.no_grad():
        want = full.eval()(torch.from_numpy(spec))
    for r in d:  # the unsharded copy runs on one device as the whole model does
        assert torch.equal(r["unsharded"], want)
