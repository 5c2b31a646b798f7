"""A run whose timed path is broken underneath comes out not correct: a train
step that leaves its state unchanged, one that leaves out half of the batch
(the mean over the rest), and an enhanced answer altered where it is
produced."""

from __future__ import annotations

import pytest

import portbench.traffic.train_steps as train_steps
from portbench import system
from portbench.tests import tiny


def test_state_left_unchanged_is_not_correct(tmp_path, monkeypatch):
    build = train_steps.build_step

    def frozen(ctx, model):
        step, opt = build(ctx, model)
        monkeypatch.setattr(opt, "step", lambda grads: True)
        return step, opt

    monkeypatch.setattr(train_steps, "build_step", frozen)
    line = tiny.run_cell("hvit28m.train_b16", tmp_path)
    assert line["correct"] is False
    assert line["checks"]["change_norm_gap_max"]["value"] > 0.5


def test_half_the_batch_is_not_correct(tmp_path, monkeypatch):
    build = train_steps.build_step

    def half(ctx, model):
        step, opt = build(ctx, model)
        return (lambda b: step({k: v[: len(v) // 2] for k, v in b.items()})), opt

    monkeypatch.setattr(train_steps, "build_step", half)
    line = tiny.run_cell("hvit28m.train_b16", tmp_path)
    assert line["correct"] is False
    assert line["checks"]["loss_step1_rel"]["value"] > line["checks"]["loss_step1_rel"]["limit"]


@pytest.mark.parametrize("workload", ["hvit28m.offline_b32", "hvit28m.serve_open"])
def test_altered_answer_is_not_correct(workload, tmp_path, monkeypatch):
    enhancer = system.port("inference.enhancer")
    istft = enhancer.istft_polar
    monkeypatch.setattr(enhancer, "istft_polar", lambda *a, **k: istft(*a, **k) * 1.01)
    line = tiny.run_cell(workload, tmp_path)
    assert line["correct"] is False
    assert line["checks"]["pcm16_lsb_max"]["value"] > line["checks"]["pcm16_lsb_max"]["limit"]
