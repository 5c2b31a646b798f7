"""The port's recorder of host spans and counters (``utils/tracing.py``) on
the CPU, and the spans the train step, the enhancer and the server record.

* Off (the default), ``span`` is the shared no-op and nothing is kept; on,
  spans nest, take their parent's id, give self times, stay per thread, and
  the ring keeps only its capacity. Counters lose no update under threads.
* The train step records ``train.step`` and its six children once a step,
  in order, and its outputs and parameters are bitwise the same with the
  recorder on and off.
* ``enhance_batch_async`` and ``result()`` record their spans under one
  batch id, and the counters match the batch's true and padded samples.
* A request to the server shows one ``serve.queue_wait``, and ``/stats``
  its new fields, counted by the batcher alone.
* The recorder reads nothing of the device: an AST check.
"""

import ast
import inspect
import json
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.augmentation import (
    SpecAugmentConfig,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.wavio import (
    read_wav_bytes,
    wav_bytes,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
    AudioEnhancer,
    make_server,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
    HybridViT,
    init_weights,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import STFTConfig
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.losses import (
    LossConfig,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.optimizer import (
    Optimizer,
    parameters,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.trainer import (
    batch_to_device,
    make_step_fns,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils import tracing

torch.set_num_threads(2)

SR = 16000
TINY = dict(embed_dim=32, num_heads=2, num_layers=1, mlp_ratio=2.0,
            encoder_channels=(8, 16, 32), decoder_channels=(16, 8, 4, 1),
            dropout=0.0, attn_dropout=0.0, drop_path_rate=0.0)
STEP_CHILDREN = ("train.featurize", "train.forward", "train.backward", "train.norm",
                 "train.sync", "train.optimizer")


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and leaves the recorder off and empty."""
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


class FakeClock:
    """``time`` for the recorder: ``perf_counter`` reads ``now``."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


def _delta(before, name):
    return tracing.counters().get(name, 0) - before.get(name, 0)


# ---------------------------------------------------------------- recorder

@pytest.mark.parametrize("call", ["span", "span_with_id", "record"])
def test_off_records_nothing(call, monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(tracing, "time", clock)
    if call == "record":
        tracing.record("a", 0.0, 1.0, 3)
    else:
        s = tracing.span("a", 7 if call == "span_with_id" else None)
        assert s is tracing.NO_SPAN
        with s as inside:
            assert inside is None
    assert tracing.spans() == []


def test_off_span_reads_no_clock(monkeypatch):
    class NoClock:
        def perf_counter(self):
            raise AssertionError("the clock was read with the recorder off")

    monkeypatch.setattr(tracing, "time", NoClock())
    for _ in range(3):
        with tracing.span("a"), tracing.span("b", 1):
            pass


def test_nesting_parents_ids_and_self_time(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(tracing, "time", clock)
    tracing.enable()
    with tracing.span("outer", 5):
        clock.now += 1.0
        with tracing.span("child"):
            clock.now += 2.0
            with tracing.span("grandchild", 9):
                clock.now += 4.0
        clock.now += 8.0
        with tracing.span("child"):
            clock.now += 16.0
    with tracing.span("next"):
        clock.now += 32.0
    got = {(s.name, s.start): s for s in tracing.spans()}
    outer, c1, g, c2, nxt = (got[k] for k in (("outer", 0.0), ("child", 1.0),
                                              ("grandchild", 3.0), ("child", 15.0),
                                              ("next", 31.0)))
    assert [s.name for s in tracing.spans()] == ["grandchild", "child", "child", "outer", "next"]
    assert (outer.parent, c1.parent, g.parent, c2.parent, nxt.parent) == (
        -1, outer.serial, c1.serial, outer.serial, -1)
    assert (outer.id, c1.id, g.id, c2.id, nxt.id) == (5, 5, 9, 5, None)
    assert (outer.end - outer.start, c1.end - c1.start, nxt.end - nxt.start) == (31.0, 6.0, 32.0)
    own = dict(zip([(s.name, s.start) for s in tracing.spans()],
                   tracing.self_seconds(tracing.spans())))
    assert own == {("grandchild", 3.0): 4.0, ("child", 1.0): 2.0, ("child", 15.0): 16.0,
                   ("outer", 0.0): 9.0, ("next", 31.0): 32.0}
    assert len({s.thread for s in tracing.spans()}) == 1


def test_record_keeps_an_interval_timed_elsewhere():
    tracing.enable()
    with tracing.span("around", 1):
        tracing.record("wait", 2.0, 3.5, 42)
    wait = next(s for s in tracing.spans() if s.name == "wait")
    assert (wait.start, wait.end, wait.id, wait.parent) == (2.0, 3.5, 42, -1)


def test_parents_stay_on_their_thread():
    tracing.enable()
    inside = threading.Event()
    go = threading.Event()

    def other():
        with tracing.span("other"):
            inside.set()
            go.wait(timeout=30)

    t = threading.Thread(target=other)
    with tracing.span("main", 1):
        t.start()
        assert inside.wait(timeout=30)
        with tracing.span("main.child"):
            pass
        go.set()
        t.join(timeout=30)
    assert not t.is_alive()
    by = {s.name: s for s in tracing.spans()}
    assert by["other"].parent == -1 and by["other"].id is None
    assert by["main.child"].parent == by["main"].serial
    assert by["other"].thread != by["main"].thread


@pytest.mark.parametrize("how", ["span", "record"])
def test_ring_keeps_only_its_capacity(how):
    n = 3 * tracing.CAPACITY + 7
    tracing.enable()
    for i in range(n):
        if how == "span":
            with tracing.span("s", i):
                pass
        else:
            tracing.record("s", 0.0, 1.0, i)
    kept = tracing.spans()
    assert len(kept) == tracing.CAPACITY
    assert [s.id for s in kept] == list(range(n - tracing.CAPACITY, n))
    tracing.clear()
    assert tracing.spans() == []


def test_counters_lose_no_update_under_threads():
    before = tracing.counters()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [tracing.count("test.hits", 3)
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert _delta(before, "test.hits") == 16 * 2000 * 3
    assert tracing.count("test.hits", 0) == tracing.counters()["test.hits"]


@pytest.mark.parametrize("profiler_ranges", [False, True])
def test_profiler_mode(profiler_ranges):
    tracing.enable(profiler_ranges=profiler_ranges)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("test.ranged"):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert ("test.ranged" in names) == profiler_ranges
    assert [s.name for s in tracing.spans()] == ["test.ranged"]
    tracing.disable()
    assert tracing.span("test.ranged") is tracing.NO_SPAN


def test_recorder_reads_nothing_of_the_device():
    """``utils/tracing.py`` names nothing of ``torch.cuda``, reads no tensor
    and imports nothing of torch but ``torch.profiler.record_function``."""
    tree = ast.parse(inspect.getsource(tracing))
    reads = {"cuda", "synchronize", "item", "tolist", "numpy", "cpu", "to", "Event"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            assert node.attr not in reads, node.attr
        if isinstance(node, ast.Name):
            assert node.id not in ("torch", "cuda"), node.id
        if isinstance(node, ast.Import):
            assert not any(a.name.split(".")[0] == "torch" for a in node.names)
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("torch"):
            assert node.module == "torch.profiler"
            assert [a.name for a in node.names] == ["record_function"]


# -------------------------------------------------------------- train step

def _train_batch(rng, rows=2, frames=64, hop=128):
    n = (frames - 1) * hop
    lens = np.array([n, n - 3000][:rows], np.int32)
    noisy = np.zeros((rows, n), np.int16)
    clean = np.zeros_like(noisy)
    for r, m in enumerate(lens):
        c = 0.3 * np.sin(2 * np.pi * (180 + 40 * r) * np.arange(m) / SR)
        clean[r, :m] = (c * 32767).astype(np.int16)
        noisy[r, :m] = (np.clip(c + 0.1 * rng.standard_normal(m), -1, 1) * 32767).astype(np.int16)
    return {"noisy_audio": noisy, "clean_audio": clean, "length": lens,
            "valid": np.ones(rows, bool)}


def _run_steps(record: bool, batches):
    model = init_weights(HybridViT(**TINY), torch.Generator().manual_seed(0))
    opt = Optimizer(parameters(model), "adamw", lr=1e-3)
    step, _ = make_step_fns(model, opt, LossConfig(log_l1_weight=0.05), STFTConfig(),
                            SpecAugmentConfig(), augment=False, use_attention_mask=True,
                            output_mode="mask")
    if record:
        tracing.enable()
    metrics = [step(batch_to_device(b, "cpu")) for b in batches]
    tracing.disable()
    return metrics, {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_train_step_spans_and_bitwise_equal_outputs(rng):
    batches = [_train_batch(rng) for _ in range(2)]
    off_metrics, off_state = _run_steps(False, batches)
    assert tracing.spans() == []
    first = tracing.counters().get("train.steps", 0) + 1
    on_metrics, on_state = _run_steps(True, batches)
    for a, b in zip(off_metrics, on_metrics):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for k in off_state:
        assert torch.equal(off_state[k], on_state[k]), k

    kept = tracing.spans()
    assert [s.name for s in kept].count("train.h2d") == 2
    steps = [s for s in kept if s.name == "train.step"]
    assert [s.id for s in steps] == [first, first + 1]
    for s in steps:
        kids = sorted((c for c in kept if c.parent == s.serial), key=lambda c: c.start)
        assert tuple(c.name for c in kids) == STEP_CHILDREN
        assert all(c.id == s.id and s.start <= c.start <= c.end <= s.end for c in kids)
        assert all(a.end <= b.start for a, b in zip(kids, kids[1:]))
    h2d = [s for s in kept if s.name == "train.h2d"]
    assert h2d[0].end <= steps[0].start and steps[0].end <= h2d[1].start


def test_nonfinite_step_skips_the_optimizer(rng):
    batch = _train_batch(rng)
    model = init_weights(HybridViT(**TINY), torch.Generator().manual_seed(0))
    opt = Optimizer(parameters(model), "adamw", lr=1e-3)
    step, _ = make_step_fns(model, opt, LossConfig(), STFTConfig(), SpecAugmentConfig(),
                            augment=False)
    with torch.no_grad():
        next(model.parameters()).fill_(float("nan"))
    before = tracing.counters()
    tracing.enable()
    out = step(batch_to_device(batch, "cpu"))
    assert float(out["nonfinite_skipped"]) == 1.0
    assert _delta(before, "train.steps") == 1
    step_span = next(s for s in tracing.spans() if s.name == "train.step")
    kids = [s.name for s in tracing.spans() if s.parent == step_span.serial]
    assert "train.sync" in kids and "train.optimizer" not in kids


# ---------------------------------------------------------------- enhancer

@pytest.fixture(scope="module")
def enhancer():
    model = init_weights(HybridViT(**TINY, pos_embed_type="factored_2d"),
                         torch.Generator().manual_seed(1))
    return AudioEnhancer(model, {"model": {"output_mode": "mask"}}, device="cpu",
                         buckets=(128, 256), io_dtype="int16", mask_padding=True)


def _clip(rng, n):
    return (0.3 * np.sin(2 * np.pi * 220 * np.arange(n) / SR)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("lengths", [(SR,), (4000, 20000, 9000)])
def test_enhance_batch_spans_share_one_id(enhancer, rng, lengths):
    wavs = [_clip(rng, n) for n in lengths]
    before = tracing.counters()
    tracing.enable()
    out = enhancer.enhance_batch_async(wavs).result()
    tracing.disable()
    wav_len = enhancer._padded_len(max(lengths))
    assert out.shape == (len(wavs), wav_len)
    assert _delta(before, "enhance.batches") == 1
    assert _delta(before, "enhance.true_samples") == sum(lengths)
    assert _delta(before, "enhance.padded_samples") == len(wavs) * wav_len

    kept = tracing.spans()
    bid = tracing.counters()["enhance.batches"]
    assert {s.id for s in kept} == {bid}
    by = {s.name: s for s in kept}
    assert sorted(by) == sorted(["enhance.dispatch", "enhance.pad", "enhance.stage",
                                 "enhance.launch", "enhance.result", "enhance.wait",
                                 "enhance.unpack"])  # no d2h on the CPU
    assert len(kept) == len(by)
    for child in ("enhance.pad", "enhance.stage", "enhance.launch"):
        assert by[child].parent == by["enhance.dispatch"].serial
    for child in ("enhance.wait", "enhance.unpack"):
        assert by[child].parent == by["enhance.result"].serial
    assert by["enhance.dispatch"].end <= by["enhance.result"].start


def test_enhance_counts_with_the_recorder_off(enhancer, rng):
    before = tracing.counters()
    enhancer.enhance(_clip(rng, 3000), exact=True)
    enhancer.enhance_batch([_clip(rng, 5000), _clip(rng, 7000)])
    assert tracing.spans() == []
    assert _delta(before, "enhance.batches") == 2
    assert _delta(before, "enhance.true_samples") == 3000 + 12000
    assert _delta(before, "enhance.padded_samples") == 3000 + 2 * enhancer._padded_len(7000)


# ------------------------------------------------------------------ server

def test_server_request_queue_wait_and_stats(enhancer, rng):
    server = make_server(enhancer, port=0, max_batch=4, max_wait_ms=20.0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        host, port = server.server_address[:2]
        url = f"http://{host}:{port}"
        tracing.enable()
        w = _clip(rng, 12000)
        body = urllib.request.urlopen(
            urllib.request.Request(f"{url}/enhance", data=wav_bytes(w, SR, subtype="float32")),
            timeout=120).read()
        assert read_wav_bytes(body, SR)[0].shape == w.shape
        enhancer.enhance_batch([_clip(rng, 5000)])  # not the server's: not in its /stats
        stats = json.loads(urllib.request.urlopen(f"{url}/stats", timeout=30).read())
    finally:
        tracing.disable()
        server.shutdown()
        server.batcher.close()
        server.server_close()
        t.join(timeout=10)
    assert not t.is_alive()
    kept = tracing.spans()
    waits = [s for s in kept if s.name == "serve.queue_wait"]
    assert len(waits) == 1
    rid = waits[0].id
    names = {s.name for s in kept if s.id == rid}
    assert {"serve.parse", "serve.queue_wait", "serve.process", "serve.reply"} <= names
    process = next(s for s in kept if s.name == "serve.process")
    dispatch = next(s for s in kept if s.name == "enhance.dispatch")
    assert dispatch.parent == process.serial and dispatch.id != rid  # the batch's own id
    assert stats["requests"] == 1 and stats["batches"] == 1
    wait_ms = 1e3 * (waits[0].end - waits[0].start)
    assert stats["queue_wait_ms_mean"] == pytest.approx(wait_ms, rel=1e-9, abs=1e-9)
    assert stats["process_ms_mean"] >= 1e3 * (process.end - process.start) > 0.0
    padded = enhancer._padded_len(len(w))
    assert stats["padding_pct"] == pytest.approx(100.0 * (1.0 - len(w) / padded))


# ------------------------------------------------------ tools/tracecheck

@pytest.mark.parametrize("mode", ["traced-train", "traced-offline", "blocks-next", "span"])
def test_tracecheck_on_the_cpu(mode, tmp_path):
    """The tool that reads the recorder in the benchmark's cells, on a cut
    configuration: its window spans add up, and it leaves the recorder off
    and its counters as they were wired."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools import (
        tracecheck,
    )

    argv = {"traced-train": ["traced", "--workload", "hvit28m.train_b16", "--seconds", "1.5"],
            "traced-offline": ["traced", "--workload", "hvit28m.offline_b32", "--seconds", "1.5"],
            "blocks-next": ["blocks", "--what", "offline", "--blocks", "2", "--per-block", "3",
                            "--units", "next"],
            "span": ["span"]}[mode]
    count = tracing.count
    assert tracecheck.main([*argv, "--tiny", "--seeds", "3000000019", "--out", str(tmp_path)]) == 0
    assert tracing.count is count and not tracing._on
    (out,) = tmp_path.glob("*.jsonl")
    line = json.loads(out.read_text().splitlines()[-1])
    if mode == "traced-train":
        prog, bench = line["window_prog"], line["window_bench"]
        assert {*STEP_CHILDREN, "train.step", "train.h2d"} <= set(prog)
        assert prog["train.step"]["n"] == bench["step"]["n"] > 0
        assert 0.9 < line["ratios"]["train.step/step"] <= 1.0
        assert line["window_counts"]["train.steps"] == bench["step"]["n"]
    elif mode == "traced-offline":
        prog, bench = line["window_prog"], line["window_bench"]
        assert prog["enhance.dispatch"]["n"] == bench["dispatch"]["n"] > 0
        assert 0.9 < line["ratios"]["enhance.dispatch/dispatch"] <= 1.0
        assert 0.9 < line["ratios"]["parts/enhance.dispatch"] <= 1.0
        assert 0.0 < line["padding_pct"] < 100.0
    elif mode == "blocks-next":
        assert [r["first"] for r in line["rows"]] == [0, 3, 6, 9]
        assert [r["on"] for r in line["rows"]] == [True, False, False, True]
        assert all((r["kept"] > 0) == r["on"] for r in line["rows"])
        assert len(line["rate_on_vs_off_pct"]["all"]) == 2
    else:
        assert line["span_us_on"] > line["span_us_off"] > 0.0
