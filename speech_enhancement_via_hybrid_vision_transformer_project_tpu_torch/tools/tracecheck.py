"""The port's recorder (``utils/tracing.py``) inside the cells of the
benchmark in ``portbench/``: what its spans read there, and what it costs.

Modes (each runs a cell's own traffic kind, model and inputs from
``portbench``, so it is run from the root of a checkout):

* ``traced``: the cell's traffic as in a ``--trace 1`` run (the untraced
  window, then the profiled slice), with the recorder on throughout. Per
  seed: the mean of each benchmark span and each program span that starts
  in the window, the program spans' self times, the slice's idle seconds
  split by the innermost span open at each gap's middle (the benchmark's
  own naming, over the benchmark's spans alone and over both lists), and
  the bucket padding of the window's batches from the enhancer's
  ``enhance.true_samples`` and ``enhance.padded_samples`` counters.
* ``oncost``: per seed, the cell's traffic twice in one process, the
  recorder on through the window in one run and off in the other (which
  comes first alternates with the seed); each run builds its own model.
* ``blocks``: in one process on one model, blocks of ``hvit28m.train_b16``
  steps or ``hvit28m.offline_b32`` batches, each block run twice, once
  with the recorder on and once off, in an order that alternates block by
  block. ``--units same`` gives both halves of a block the same batches;
  ``--units next`` gives each half the batches after the last one run, so
  that the halves differ in work as well.
* ``span``: the host cost of one span with the recorder off and on, and of
  one counter update.

A rate ratio is the recorder-on rate over the recorder-off rate, less 1, in
percent. Each mode appends its JSON lines, each with the card's name and
power limit, to ``OUT/<name>.jsonl`` and prints them without the long fields. ``--tiny`` runs a cut configuration and small
traffic on the CPU (no device trace), to try the modes out.

    python -m speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools.tracecheck \\
        traced --workload hvit28m.train_b16 --seeds 1 2 [--seconds 30] [--out DIR]
    ... oncost --workload hvit28m.offline_b32 --seeds 1 2 3 4 5 6
    ... blocks --what train|offline --seeds 1 2 [--blocks 12] [--per-block 25] [--units same|next]
    ... span
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import statistics
import tempfile
import time
from collections import defaultdict, deque
from pathlib import Path

import torch

from ..utils import tracing
from .flops import describe_device

BLOCK_CELLS = {"train": "hvit28m.train_b16", "offline": "hvit28m.offline_b32"}
LONG_FIELDS = ("rows", "slice_bench", "slice_prog", "idle_by_span", "device_ops")


class CountLog:
    """Every counter update while it is installed, with its host time, so
    that counters can be read over a window after the run."""

    def __init__(self):
        self.items = []
        self._count = None

    def __enter__(self):
        self._count = tracing.count

        def count(name, n=1):
            self.items.append((time.perf_counter(), name, n))
            return self._count(name, n)

        tracing.count = count
        return self

    def __exit__(self, *exc):
        tracing.count = self._count
        return False

    def between(self, t0: float, t1: float) -> dict:
        out = defaultdict(int)
        for t, name, n in self.items:
            if t0 <= t < t1:
                out[name] += n
        return dict(out)


class Bench:
    """The benchmark's pieces, imported when a mode runs."""

    def __init__(self, args):
        from portbench import run, trace

        self.run, self.trace = run, trace
        self.card = None
        run.cache_dirs(Path.cwd())
        self.config_file, self.params = None, {}
        if args.tiny:
            from portbench.tests import tiny

            self.config_file = str(tiny.config_file(Path(tempfile.mkdtemp())))
            self.params = tiny.PARAMS

    def context(self, workload: str, seed: int, seconds: float, traced: bool, device):
        cell, config, _ = self.run.load(argparse.Namespace(
            workload=workload, config_file=self.config_file))
        params = {**cell["params"], **self.params.get(cell["traffic"], {})}
        traced = traced and device.type == "cuda"
        ctx = self.run.Context(config=config, params=params, seed=seed, seconds=seconds,
                               trace=traced, control=False, device=device,
                               tracer=self.trace.Tracer(traced), spans=self.trace.Spans())
        ctx.card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        traffic = importlib.import_module(f"portbench.traffic.{cell['traffic']}")
        return traffic, ctx


def means(items, t0: float, t1: float) -> dict:
    """``{name: {n, mean_ms, sum_s}}`` of the ``(name, start, end)`` items
    that start in ``[t0, t1)``."""
    by = defaultdict(list)
    for name, a, b in items:
        if t0 <= a < t1:
            by[name].append(b - a)
    return {n: {"n": len(v), "mean_ms": 1e3 * statistics.fmean(v), "sum_s": sum(v)}
            for n, v in sorted(by.items())}


def self_means(kept, t0: float, t1: float) -> dict:
    by = defaultdict(list)
    for s, own in zip(kept, tracing.self_seconds(kept)):
        if t0 <= s.start < t1:
            by[s.name].append(own)
    return {n: 1e3 * statistics.fmean(v) for n, v in sorted(by.items())}


def idle_by_span(bench: Bench, tracer, items) -> dict:
    """The slice's idle seconds and gaps, by the innermost of ``items`` open
    at each gap's middle: every name, not the summary's ten."""
    from torch.autograd import DeviceType

    prof = tracer.prof
    offset = prof.profiler.kineto_results.trace_start_ns() * 1e-9 - tracer.wall_minus_host
    intervals = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            a = max(e.time_range.start * 1e-6 + offset, tracer.t0)
            b = min(e.time_range.end * 1e-6 + offset, tracer.t1)
            if b > a:
                intervals.append((a, b))
    busy, gaps = bench.trace._union(intervals, tracer.t0, tracer.t1)
    open_items = [s for s in items if s[2] > tracer.t0 and s[1] < tracer.t1]
    idle, n = defaultdict(float), defaultdict(int)
    for a, b in gaps:
        name = bench.trace._open_span(open_items, (a + b) / 2)
        idle[name] += b - a
        n[name] += 1
    return {"busy_s": busy, "window_s": tracer.t1 - tracer.t0, "idle_s": sum(idle.values()),
            "by_name": {k: [v, n[k]] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])}}


def traced(args, bench: Bench, device) -> None:
    for seed in args.seeds:
        traffic, ctx = bench.context(args.workload, seed, args.seconds, True, device)
        tracing.clear()
        tracing.enable()
        with CountLog() as log:
            outcome = traffic.run(ctx)
        tracing.disable()
        kept = tracing.spans()
        prog = [(s.name, s.start, s.end) for s in kept]
        t0, t1 = ctx.facts["t0"], ctx.facts["t1"]
        win_bench, win_prog = means(ctx.spans.items, t0, t1), means(prog, t0, t1)
        counts = log.between(t0, t1)
        line = {"mode": "traced", "workload": args.workload, "seed": seed, "card": bench.card,
                "e2e": outcome["e2e"], "window_s": t1 - t0, "kept_spans": len(kept),
                "window_bench": win_bench, "window_prog": win_prog,
                "window_prog_self_ms": self_means(kept, t0, t1), "window_counts": counts}
        if counts.get("enhance.padded_samples"):
            line["padding_pct"] = 100.0 * (
                1.0 - counts["enhance.true_samples"] / counts["enhance.padded_samples"])
        ratios = {}
        if "step" in win_bench and "train.step" in win_prog:
            ratios["train.step/step"] = win_prog["train.step"]["mean_ms"] / win_bench["step"]["mean_ms"]
        if "dispatch" in win_bench and "enhance.dispatch" in win_prog:
            d = win_prog["enhance.dispatch"]["mean_ms"]
            ratios["enhance.dispatch/dispatch"] = d / win_bench["dispatch"]["mean_ms"]
            ratios["parts/enhance.dispatch"] = sum(
                win_prog[k]["mean_ms"] for k in ("enhance.pad", "enhance.stage", "enhance.launch",
                                                 "enhance.d2h") if k in win_prog) / d
        line["ratios"] = ratios
        if ctx.trace:
            s0, s1 = ctx.tracer.t0, ctx.tracer.t1
            line["slice_bench"], line["slice_prog"] = (means(ctx.spans.items, s0, s1),
                                                       means(prog, s0, s1))
            bench_only = idle_by_span(bench, ctx.tracer, ctx.spans.items)
            both = idle_by_span(bench, ctx.tracer, ctx.spans.items + prog)
            units = (line["slice_prog"].get("train.step") or line["slice_prog"].get(
                "enhance.dispatch") or {"n": 0})["n"]
            named = sum(v for k, (v, _) in both["by_name"].items() if "." in k)
            line["idle_by_span"] = both
            line["slice"] = {
                "busy_s": both["busy_s"], "window_s": both["window_s"],
                "idle_s": both["idle_s"], "idle_s_bench_names": bench_only["idle_s"],
                "program_named_share": named / both["idle_s"] if both["idle_s"] else None,
                "units": units,
                "idle_ms_a_unit": {k: 1e3 * v / units for k, (v, _) in both["by_name"].items()}
                if units else None,
                "idle_share": {k: v / both["idle_s"] for k, (v, _) in both["by_name"].items()}
                if both["idle_s"] else None}
        emit(args.out, f"{args.workload}.traced", line)
        del outcome, ctx
        release()


def rate(outcome: dict) -> tuple[str, float]:
    key = next(k for k in outcome["e2e"] if k != "setup_s")
    return key, outcome["e2e"][key]


def oncost(args, bench: Bench, device) -> None:
    ratios = []
    for i, seed in enumerate(args.seeds):
        rates = {}
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            traffic, ctx = bench.context(args.workload, seed, args.seconds, False, device)
            tracing.clear()
            if on:
                tracing.enable()
            outcome = traffic.run(ctx)
            tracing.disable()
            key, rates[on] = rate(outcome)
            emit(args.out, f"{args.workload}.oncost",
                 {"mode": "oncost", "workload": args.workload, "seed": seed, "on": on,
                  "card": bench.card, "e2e": outcome["e2e"], "kept_spans": len(tracing.spans())})
            del outcome, ctx
            release()
        ratios.append(100.0 * (rates[True] / rates[False] - 1.0))
    emit(args.out, f"{args.workload}.oncost",
         {"mode": "oncost_summary", "workload": args.workload, "seeds": args.seeds,
          "metric": key, "rate_on_vs_off_pct": summary(ratios)})


def summary(ratios: list) -> dict:
    out = {"median": statistics.median(ratios), "mean": statistics.fmean(ratios), "all": ratios}
    if len(ratios) > 1:
        out["q1"], _, out["q3"] = statistics.quantiles(ratios, n=4)
    return out


def release() -> None:
    """Free what the last run left, on the host and the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def alternate(run_block, blocks: int, per_block: int, units: str, sync) -> tuple[list, list]:
    """Each block twice, recorder on and off, the order alternating block by
    block; the rate ratio of each block."""
    rows, ratios, nxt = [], [], 0
    for b in range(blocks):
        secs = {}
        for on in ((True, False) if b % 2 == 0 else (False, True)):
            first = b * per_block if units == "same" else nxt
            nxt = first + per_block
            tracing.clear()
            if on:
                tracing.enable()
            sync()
            t = time.perf_counter()
            run_block(first, per_block)
            sync()
            secs[on] = time.perf_counter() - t
            tracing.disable()
            rows.append({"block": b, "on": on, "first": first, "s": secs[on],
                         "per_unit_ms": 1e3 * secs[on] / per_block, "kept": len(tracing.spans())})
        ratios.append(100.0 * (secs[False] / secs[True] - 1.0))
    return rows, ratios


def blocks(args, bench: Bench, device) -> None:
    from portbench import system
    from portbench.traffic import offline_batches, train_steps

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for seed in args.seeds:
        _, ctx = bench.context(BLOCK_CELLS[args.what], seed, 30.0, False, device)
        system.use_precision(ctx.config)
        model, _ = system.build_model(ctx.config, ctx.seed, device)
        if args.what == "train":
            batches = train_steps.make_batches(ctx)
            step, _ = train_steps.build_step(ctx, model)
            to_device = system.port("training.trainer").batch_to_device

            def run_block(first, n):
                for i in range(first, first + n):
                    step(to_device(batches[i % len(batches)], device))

            run_block(0, 5)
        else:
            batches = offline_batches.make_batches(ctx)
            floats = [[offline_batches.clips.to_float(c) for c in rows] for _, rows in batches]
            enhancer = system.port("inference").AudioEnhancer(
                model, system.port_config(ctx.config), device=device,
                buckets=tuple(ctx.config["buckets"]), io_dtype="int16",
                mask_padding=bool(ctx.config["mask_padding"]))
            for shape in {(len(rows), n) for n, rows in batches}:
                j = next(j for j, (n, rows) in enumerate(batches) if (len(rows), n) == shape)
                enhancer.enhance_batch_async(floats[j]).result()

            def run_block(first, n):  # two batches in flight, as the cell runs them
                inflight = deque()
                for k in range(first, first + n):
                    inflight.append(enhancer.enhance_batch_async(floats[k % len(batches)]))
                    if len(inflight) == 2:
                        inflight.popleft().result()
                while inflight:
                    inflight.popleft().result()

        rows, ratios = alternate(run_block, args.blocks, args.per_block, args.units, sync)
        emit(args.out, f"blocks.{args.what}",
             {"mode": "blocks", "what": args.what, "seed": seed, "card": bench.card,
              "units": args.units, "blocks": args.blocks, "per_block": args.per_block,
              "units_in_cell": len(batches), "rate_on_vs_off_pct": summary(ratios), "rows": rows})
        del model, ctx, run_block
        release()


def span_cost(args, bench: Bench, device) -> None:
    n, line = 200_000, {"mode": "span", "card": bench.card}
    for on in (False, True):
        if on:
            tracing.enable()
        best = []
        for _ in range(5):
            t = time.perf_counter()
            for _ in range(n):
                with tracing.span("x", 1):
                    pass
            best.append(time.perf_counter() - t)
        tracing.disable()
        tracing.clear()
        line[f"span_us_{'on' if on else 'off'}"] = 1e6 * min(best) / n
    t = time.perf_counter()
    for _ in range(n):
        pass
    line["empty_loop_us"] = 1e6 * (time.perf_counter() - t) / n
    t = time.perf_counter()
    for _ in range(n):
        tracing.count("tracecheck.x")
    line["count_us"] = 1e6 * (time.perf_counter() - t) / n
    emit(args.out, "span", line)


def emit(out: str, name: str, line: dict) -> None:
    path = Path(out)
    path.mkdir(parents=True, exist_ok=True)
    with open(path / f"{name}.jsonl", "a") as f:
        f.write(json.dumps(line) + "\n")
    print(json.dumps({k: v for k, v in line.items() if k not in LONG_FIELDS}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["traced", "oncost", "blocks", "span"])
    ap.add_argument("--workload", default=None, help="traced, oncost: the cell")
    ap.add_argument("--what", default="train", choices=sorted(BLOCK_CELLS), help="blocks")
    ap.add_argument("--seeds", type=int, nargs="+", default=[2147483659])
    ap.add_argument("--seconds", type=float, default=30.0, help="traced, oncost: the window")
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--per-block", type=int, default=25)
    ap.add_argument("--units", default="same", choices=["same", "next"])
    ap.add_argument("--out", default="build/tracecheck")
    ap.add_argument("--tiny", action="store_true", help="a cut configuration on the CPU")
    args = ap.parse_args(argv)
    if args.mode in ("traced", "oncost") and not args.workload:
        ap.error(f"{args.mode} needs --workload")
    bench = Bench(args)
    device = torch.device("cpu" if args.tiny else "cuda:0")
    bench.card = describe_device(device.type)
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    {"traced": traced, "oncost": oncost, "blocks": blocks, "span": span_cost}[args.mode](
        args, bench, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
