"""The port's mesh (``parallel/``) against the JAX package's, on the CPU.

* ``make_mesh`` gives the JAX ``make_mesh``'s sizes and raises its errors
  (the JAX side on the conftest's 8 virtual devices, the port's on 8 CPU
  device entries); ``local_batch_size`` as JAX's; ``mesh_for_data_parallel``
  refuses more CUDA devices than are visible, naming both counts; the
  train CLI's ``plan_mesh`` builds its mesh with them over every host's
  devices.
* ``VoiceBankDataset.shard`` and the lockstep loader (``fixed_bucket``,
  ``max_batches``, padding batches with every row invalid) yield, on each
  of two hosts, exactly the JAX loader's batches, over two epochs. On one
  host the two data ranks' blocks of each batch (``part``) put together
  are the JAX loader's global batch, padded to that batch's own bucket.
* The tensor-parallel splitter and joiner: split then join is the identity,
  and the split leaves are those JAX ``tp_param_specs`` shards, along the
  same dimension (the port splits ``[out, in]`` torch weights, JAX
  ``[in, out]`` kernels).
* The launcher: when one worker fails, the call raises and the other, still
  running, is terminated.

Planted faults that fail them (checked in a scratch copy): a loader that
ends an exhausted shard without its padding batch fails the
``train-padding-batch`` case; one that pads a rank's block to its own rows'
bucket fails the one-host case; a qkv split into contiguous rows (JAX's
layout, not whole heads) fails split-then-join.
"""

import re
import time
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.data.dataset import (
    DataLoader as JDataLoader,
    VoiceBankDataset as JVoiceBankDataset,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.models import HybridViT as JHybridViT
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.parallel import (
    MODEL_AXIS,
    local_batch_size as j_local_batch_size,
    make_mesh as j_make_mesh,
    tp_param_specs as j_tp_param_specs,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.dataset import (
    DataLoader,
    VoiceBankDataset,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.wavio import save_wav
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
    HybridViT,
    init_weights,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.parallel import (
    join_state_dicts,
    launch,
    local_batch_size,
    make_mesh,
    mesh_for_data_parallel,
    split_state_dict,
    tp_param_specs,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
    _torch_name,
)
from test_torch_model import SMALL, _jax_template
from torch_mesh_worker import exit_on_rank

torch.set_num_threads(2)

SR = 16000
CPU8 = [torch.device("cpu")] * 8


@pytest.mark.parametrize("dp,mp", [(-1, 1), (-1, 2), (4, 2), (2, 4), (8, 1), (-1, 8),
                                   (3, 1), (-1, 3), (5, 2), (1, 1)])
def test_make_mesh_matches_jax(dp, mp):
    try:
        jmesh = j_make_mesh(dp, mp)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            make_mesh(dp, mp, CPU8)
        return
    mesh = make_mesh(dp, mp, CPU8)
    assert mesh.shape == dict(jmesh.shape) and mesh.size == 8
    for r in range(8):  # rank r sits where JAX puts device r (model innermost)
        m = replace(mesh, rank=r)
        assert jmesh.devices[m.data_rank, m.model_rank] == jax.devices()[r]
    for batch in (16, 12):
        try:
            j = j_local_batch_size(batch, jmesh)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                local_batch_size(batch, mesh)
        else:
            assert local_batch_size(batch, mesh) == j


def test_mesh_for_data_parallel(monkeypatch):
    assert mesh_for_data_parallel(1, "cpu") is None and mesh_for_data_parallel(None) is None
    mesh = mesh_for_data_parallel(3, "cpu")
    assert mesh.shape == {"data": 3, "model": 1}
    assert mesh.replicas == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh_for_data_parallel(2, "cuda").replicas == [torch.device("cuda", 0),
                                                         torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="3 CUDA devices asked for, but 2 visible"):
        mesh_for_data_parallel(3, "cuda")


@pytest.mark.parametrize("device,cards,hosts,dp,mp,shape,local", [
    ("cuda", 4, 1, -1, 1, (4, 1), ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    ("cuda", 4, 1, -1, 2, (2, 2), ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    ("cuda", 4, 1, 2, 1, (2, 1), ["cuda:0", "cuda:1"]),
    ("cuda", 2, 2, -1, 1, (4, 1), ["cuda:0", "cuda:1"]),
    ("cpu", 0, 1, -1, 2, (1, 2), ["cpu", "cpu"]),
    ("cpu", 0, 2, 2, 2, (2, 2), ["cpu", "cpu"]),
    ("cuda", 4, 1, -1, 3, "model_parallel=3 does not divide 4 devices", None),
    ("cpu", 0, 2, 1, 2, r"the data axis \(1\) must be a multiple of the hosts \(2\)", None),
])
def test_train_cli_plans_its_mesh_with_make_mesh(monkeypatch, device, cards, hosts, dp, mp,
                                                 shape, local):
    """The train CLI's mesh is ``mesh_from_config`` over every host's
    devices (``-1``: every card; on the CPU one device a model rank), with
    ``make_mesh``'s errors; each host holds whole data ranks."""
    from argparse import Namespace

    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli.train import (
        plan_mesh,
    )

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    args = Namespace(device=device, num_processes=hosts, process_id=hosts - 1,
                     coordinator="localhost:1" if hosts > 1 else None)
    config = {"mesh": {"data_parallel": dp, "model_parallel": mp},
              "training": {"batch_size": 8}, "model": {"transformer": {"num_heads": 6}}}
    if local is None:
        with pytest.raises(SystemExit, match=shape):
            plan_mesh(args, config)
        return
    plan = plan_mesh(args, config)
    assert (plan.mesh.data, plan.mesh.model) == shape and plan.local == len(local)
    assert list(plan.mesh.devices) == [torch.device(d) for d in local] * hosts


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("vb")
    rng = np.random.default_rng(3)
    for i in range(7):
        n = int(rng.uniform(0.3, 1.5) * SR)  # the longest beyond the 128-frame bucket
        clean = (0.4 * np.sin(np.arange(n) * rng.uniform(0.02, 0.08))).astype(np.float32)
        save_wav(root / "clean_trainset_28spk_wav" / f"p{i:03d}.wav", clean, SR)
        save_wav(root / "noisy_trainset_28spk_wav" / f"p{i:03d}.wav",
                 clean + 0.1 * rng.standard_normal(n).astype(np.float32), SR)
    return root


@pytest.mark.parametrize("shuffle,max_batches", [(True, 3), (False, 2)],
                         ids=["train-padding-batch", "val-short-batch"])
def test_shard_and_lockstep_loader_match_jax(data_root, shuffle, max_batches):
    """Two hosts, local batch 2, every batch in the 128-frame bucket: host 1
    holds 3 files, so its second batch has an invalid row, and with 3 batches
    an epoch both hosts end on a padding batch (every row invalid)."""
    config = {"data": {"train_val_split": 1.0}}
    for host in range(2):
        ds = VoiceBankDataset(data_root, "train", config).shard(host, 2)
        jds = JVoiceBankDataset(data_root, "train", config).shard(host, 2)
        assert ds.file_pairs == jds.file_pairs and len(ds) == (4, 3)[host]
        kw = dict(batch_size=2, shuffle=shuffle, num_workers=2, seed=5, buckets=(64, 128),
                  fixed_bucket=128, max_batches=max_batches)
        loader, jloader = DataLoader(ds, **kw), JDataLoader(jds, **kw)
        assert len(loader) == len(jloader) == max_batches
        for _ in range(2):  # two epochs: the shuffle moves on with the epoch
            ours, theirs = list(loader), list(jloader)
            assert len(ours) == len(theirs) == max_batches
            for a, b in zip(ours, theirs):
                assert set(a) == set(b)
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                assert a["noisy_audio"].shape == (2, 127 * 128)
        if shuffle:
            assert not ours[-1]["valid"].any()  # the padding batch
        else:
            assert ours[-1]["valid"].tolist() == [[True, True], [True, False]][host]


@pytest.mark.parametrize("shuffle", [True, False], ids=["train", "val"])
def test_one_host_ranks_split_the_jax_global_batch(data_root, shuffle):
    """One host, two data ranks, global batch 4 over 7 files: each rank's
    ``part`` of every batch, put together with the other's, is the JAX
    loader's batch (the second one short: a pad row on rank 1), in that
    batch's own bucket, not the largest."""
    config = {"data": {"train_val_split": 1.0}}
    kw = dict(batch_size=4, shuffle=shuffle, num_workers=2, seed=5, buckets=(64, 128, 256, 384))
    jloader = JDataLoader(JVoiceBankDataset(data_root, "train", config), **kw)
    loaders = [DataLoader(VoiceBankDataset(data_root, "train", config), part=(r, 2), **kw)
               for r in range(2)]
    assert len(loaders[0]) == len(jloader) == 2
    for _ in range(2):  # two epochs: the shuffle moves on with the epoch
        ranks = [list(loader) for loader in loaders]
        theirs = list(jloader)
        for bi, b in enumerate(theirs):
            for k in b:
                assert ranks[0][bi][k].shape[0] == ranks[1][bi][k].shape[0] == 2
                np.testing.assert_array_equal(
                    np.concatenate([ranks[0][bi][k], ranks[1][bi][k]]), b[k], err_msg=k)
        # (each epoch's last batch holds a rank whose own rows fit a smaller bucket)
        assert {b["noisy_audio"].shape[1] for b in theirs} <= {127 * 128, 255 * 128}
        assert ranks[1][-1]["valid"].tolist() == [True, False]
    with pytest.raises(ValueError, match="part"):
        DataLoader(VoiceBankDataset(data_root, "train", config), batch_size=3, part=(0, 2))


def _model_and_specs():
    """The port model's state dict and JAX ``tp_param_specs`` of the same
    architecture, keyed by the port's names."""
    model = init_weights(HybridViT(**SMALL), torch.Generator().manual_seed(0))
    template = _jax_template(JHybridViT(**SMALL), np.zeros((1, 257, 64, 1), np.float32))
    flat = jax.tree_util.tree_flatten_with_path(j_tp_param_specs(template))[0]
    jspecs = {}
    for path, spec in flat:
        keys = tuple(getattr(e, "key", getattr(e, "name", None)) for e in path)
        if keys[0] == "params":
            jspecs[_torch_name(keys[1:])] = spec
    return model.state_dict(), jspecs


@pytest.mark.parametrize("parts", [2, 4])
def test_tp_split_then_join_is_the_identity(parts):
    sd, _ = _model_and_specs()
    shards = [split_state_dict(sd, parts, m) for m in range(parts)]
    for name, spec in tp_param_specs(sd).items():
        for s in shards:
            if spec is None:
                assert s[name].shape == sd[name].shape
            else:
                assert s[name].numel() * parts == sd[name].numel(), name
    joined = join_state_dicts(shards)
    assert set(joined) == set(sd)
    for k, v in sd.items():
        assert torch.equal(joined[k], v), k
    # whole heads: shard m's q, k and v rows are heads [m*H/p, (m+1)*H/p)
    w = sd["transformer.blocks.0.attn.qkv.weight"]
    d = SMALL["embed_dim"]
    qkv = shards[1]["transformer.blocks.0.attn.qkv.weight"].reshape(3, d // parts, d)
    for i in range(3):
        assert torch.equal(qkv[i], w[i * d + d // parts: i * d + 2 * d // parts])


def test_tp_split_leaves_match_jax_tp_param_specs():
    sd, jspecs = _model_and_specs()
    ours = tp_param_specs(sd)
    # every JAX leaf named in the port; the port's extra entries are buffers
    assert set(jspecs) <= set(ours)
    assert {k for k, s in jspecs.items() if s != P()} == {k for k, s in ours.items() if s is not None}
    # JAX's column split (output dim of [in, out]) is dim 0 of [out, in] (or
    # whole heads, along dim 0); its row split (input dim) is dim 1
    for name, spec in jspecs.items():
        if spec == P(None, MODEL_AXIS) or spec == P(MODEL_AXIS) and name.endswith("bias"):
            assert ours[name] in (0, "heads"), name
        elif spec == P(MODEL_AXIS, None):
            assert ours[name] == 1, name
        else:
            assert ours[name] is None, name
    assert len([s for s in ours.values() if s is not None]) == 6 * SMALL["num_layers"]


def test_launch_stops_the_others_when_a_worker_fails():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="worker rank 1 exited with code 3"):
        launch(exit_on_rank, (1, 3, 120.0), nprocs=2, timeout=200)
    assert time.monotonic() - t0 < 100  # rank 0 would sleep 120 s
