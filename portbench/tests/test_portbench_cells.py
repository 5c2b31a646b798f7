"""Every cell and metric the benchmark names is found by name, the dry run of
each traffic kind prints one well-formed line, and nothing under portbench/
imports JAX (or the reference anything of the port)."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run
from portbench.tests import tiny

BENCH = tiny.BENCH
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = sorted(p.stem for p in (BENCH / "workloads").glob("*.json"))
JAX_PACKAGE = "speech_enhancement_via_hybrid_vision_transformer_project_tpu"
PORT = JAX_PACKAGE + "_torch"


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_file_loads_and_its_traffic_is_found(name):
    cell = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    assert cell["name"] == name
    assert (BENCH / "configs" / f"{cell['config']}.json").is_file()
    mod = __import__(f"portbench.traffic.{cell['traffic']}", fromlist=["run"])
    assert callable(mod.run)
    assert cell["limits"] and all(isinstance(v, float) for v in cell["limits"].values())


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_benchmark_cell_matches_its_file(cell):
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    f = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
        f["config"], f["traffic"], f["chips"], f["why"])
    e2e, layer = run.cell_metrics(SPEC, cell)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer


@pytest.mark.parametrize("name", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_is_found(name):
    assert callable(run.reader(name))


def test_config_files_are_the_benchmarks():
    for c in SPEC["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert f["reduced"] == c["reduced"]


@pytest.mark.parametrize("workload", ["hvit28m.serve_open", "hvit28m.offline_b32",
                                      "hvit28m.train_b16"])
def test_cpu_dry_run_prints_one_line_with_null_timings(workload, tmp_path):
    out = subprocess.run([sys.executable, "-m", "portbench.run",
                          *tiny.argv(workload, tmp_path)],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    assert line["metrics"] and all(m["value"] is None for m in line["metrics"].values())
    assert line["correct"] is True, line["checks"]
    assert "check " in out.stderr.strip().splitlines()[-1]


def test_no_card_means_no_result(tmp_path):
    """Without a card (this machine) the plain command exits non-zero and
    prints nothing."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "hvit28m.train_b16", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def _imports(path: Path) -> set[str]:
    """Top-level names a file imports: import statements (a relative import
    that leaves its own package counts as ``portbench``) and
    ``import_module``/``__import__`` of a constant name."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module if node.level == 0 else
                      "portbench" if node.level > 1 else "")
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value)
    return {n.split(".")[0] for n in names if n}


def test_nothing_imports_jax_and_the_reference_nothing_of_the_port():
    banned = {"jax", "jaxlib", "flax", "optax", JAX_PACKAGE}
    for path in BENCH.rglob("*.py"):
        tops = _imports(path)
        assert not tops & banned, (path, tops & banned)
    for path in (BENCH / "reference").rglob("*.py"):
        tops = _imports(path)
        assert PORT not in tops and "portbench" not in tops, (path, tops)


def test_reads_nothing_of_the_old_benchmarks():
    for path in BENCH.rglob("*.py"):
        text = path.read_text()
        for old in ("benchmarks/", "bench.py", "BENCH_r", "BASELINE", "MULTICHIP_"):
            assert old not in text or path.name.startswith("test_"), (path, old)
