"""Run one cell of the benchmark and print its result line.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is ``portbench/workloads/<name>.json``: its configuration
(``configs/<config>.json``), its traffic kind (``traffic/<kind>.py``, whose
``run(ctx)`` makes the inputs from the seed, builds and warms the system,
drives the window and returns its counts and timings) and the traffic's
parameters and correctness limits. Which metrics the cell reports comes from
``BENCHMARK.json``; each per-layer metric is read by ``metrics/<name>.py``.
The last line of standard output is one JSON object; the numbers compared
for ``correct`` end standard error and that line.

Extra options, never given by the driver: ``--device cpu`` runs a cell on
the CPU with the kernels' plain versions and reports no timing (tests; a
small configuration file with ``--config-file``); ``--control 1`` also
reads the control (the reference in TF32 in the program's place) and prints
its numbers under ``control``; ``--param k=v`` overrides a traffic
parameter (the serving cell's rate sweep).
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
JAX_NAMES = ("jax", "jaxlib", "flax", "optax",
             "speech_enhancement_via_hybrid_vision_transformer_project_tpu")


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its kernels under ``build/torch_kernels`` and
    ``build/torch_native`` by itself), and no JAX behind a library's back."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


@dataclass
class Context:
    """What a traffic module is given, and where it leaves what the
    per-layer readers read."""

    config: dict
    params: dict
    seed: int
    seconds: float
    trace: bool
    control: bool
    device: object
    tracer: object
    spans: object
    facts: dict = field(default_factory=dict)
    summary: dict | None = None
    card: str | None = None


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(name: str):
    """The ``read(ctx)`` of per-layer metric ``name``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, name: str) -> tuple[list, list]:
    """The end-to-end and per-layer metrics that cell ``name`` reports."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return e2e, layer


def jax_loaded() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in JAX_NAMES)


def parse_param(s: str) -> tuple[str, object]:
    k, v = s.split("=", 1)
    return k, json.loads(v)


def run_one(args, cell: dict, config: dict, bench: dict, device) -> dict:
    import torch

    from . import T_START, trace

    e2e_specs, layer_specs = cell_metrics(bench, args.workload)
    params = dict(cell["params"])
    params.update(dict(args.param))
    tracer = trace.Tracer(bool(args.trace) and device.type == "cuda")
    ctx = Context(config=config, params=params, seed=args.seed,
                  seconds=float(args.seconds), trace=bool(args.trace),
                  control=bool(args.control), device=device, tracer=tracer,
                  spans=trace.Spans())
    cuda = device.type == "cuda"
    if cuda:
        ctx.card = torch.cuda.get_device_name(device)
        torch.cuda.reset_peak_memory_stats(device)
    t_ready = time.perf_counter()
    traffic = importlib.import_module(f"portbench.traffic.{cell['traffic']}")
    outcome = traffic.run(ctx)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    if ctx.trace and cuda:
        ctx.summary = tracer.summarize(ctx.spans)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, control = outcome["check"]()
    limits = cell["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items() if k in limits}
    readings = dict(outcome.get("readings", {}))
    if ctx.trace and cuda:
        from .readers import slice_idle_pct, tracing_cost_pct

        readings["tracing_cost_pct"] = tracing_cost_pct(ctx)
        readings["slice_idle_pct"] = slice_idle_pct(ctx)
    t0 = ctx.facts.get("t0", t_ready)
    readings["setup_parts_s"] = {"torch_and_card": t_ready - T_START, **{
        name: sum(ctx.spans.durations(name, t_ready, t0)) for name in trace.SETUP_SPANS}}
    readings.update((k, v) for k, v in numbers.items() if k not in limits)
    correct = bool(checks) and all(
        c["limit"] is not None and c["value"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"]
        for c in checks.values())

    metrics = {}
    if ctx.trace:
        for m in layer_specs:
            value = reader(m["name"])(ctx) if cuda else None
            if value is not None or not cuda:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e_specs:
            value = outcome["e2e"].get(m["name"]) if cuda else None
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": ctx.card if cuda else "cpu", "count": 1, "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": outcome["attempted"],
            "failed": outcome["failed"], "metrics": metrics, "device": dev}
    if ctx.summary is not None:
        dev["busy_s"] = ctx.summary["busy_s"]
        dev["window_s"] = ctx.summary["window_s"]
        line["breakdown"] = {"device_ops": ctx.summary["device_ops"],
                             "idle_gaps": ctx.summary["idle_gaps"]}
    if args.control:
        line["control"] = control
    line["readings"] = readings
    line["checks"] = checks
    return line


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True, type=int)
    ap.add_argument("--seconds", required=True, type=float)
    ap.add_argument("--trace", type=int, default=0, choices=[0, 1])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--control", type=int, default=0, choices=[0, 1])
    ap.add_argument("--param", action="append", default=[], type=parse_param)
    ap.add_argument("--config-file", default=None)
    return ap.parse_args(argv)


def load(args) -> tuple[dict, dict, dict]:
    """``(cell, config, benchmark)`` that ``args`` name."""
    root = BENCH_DIR.parent
    bench = load_json(root / "BENCHMARK.json")
    cell = load_json(BENCH_DIR / "workloads" / f"{args.workload}.json")
    config = load_json(Path(args.config_file) if args.config_file
                       else BENCH_DIR / "configs" / f"{cell['config']}.json")
    return cell, config, bench


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs(BENCH_DIR.parent)
    cell, config, bench = load(args)

    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
                  f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
    device = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    line = run_one(args, cell, config, bench, device)
    found = jax_loaded()
    if found:
        print(f"portbench: JAX was loaded in this process: {found}", file=sys.stderr)
        return 3
    for k, c in line["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
