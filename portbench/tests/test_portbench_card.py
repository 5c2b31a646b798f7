"""On the card: each cell of the benchmark, at its own size and a short
window, with the control read beside the program: the program within every
limit, the control (the reference in TF32) outside at least one."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.tests import tiny

SPEC = json.loads((tiny.BENCH.parent / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_control_fails_and_program_passes_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                          "--seed", "3700000001", "--seconds", "3", "--control", "1"],
                         cwd=tiny.BENCH.parent, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert any(line["control"][k] > c["limit"] for k, c in line["checks"].items()), line
