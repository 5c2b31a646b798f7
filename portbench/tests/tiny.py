"""A small configuration and small traffic for running the cells on the CPU."""

from __future__ import annotations

import contextlib
import io
import json
from pathlib import Path

from portbench import run

BENCH = Path(run.__file__).resolve().parent
SHORT = {"kind": "lognormal", "median_s": 1.0, "sigma": 0.5, "min_s": 0.5, "max_s": 2.0}
# traffic parameters that keep each kind to a few seconds of CPU
PARAMS = {
    "http_open_loop": {"pool": 24, "rate_per_s": 10, "warm_s": 1, "max_batch": 4,
                       "check_sample": 6, "threads": 8, "lengths": SHORT},
    "offline_batches": {"pool": 32, "batch": 8, "check_batches": 2, "lengths": SHORT},
    "train_steps": {"pool": 4, "batch": 4, "bucket_frames": 128,
                    "lengths": {"kind": "uniform", "min_s": 0.5, "max_s": 1.0}},
}


def config_file(tmp_path: Path) -> Path:
    """hvit28m with every width cut, for the CPU."""
    c = json.loads((BENCH / "configs" / "hvit28m.json").read_text())
    c["name"] = "tiny"
    c["model"]["encoder"]["channels"] = [4, 8, 16]
    c["model"]["transformer"].update(embed_dim=32, num_heads=2, num_layers=1)
    c["model"]["decoder"]["channels"] = [16, 8, 4, 1]
    c["model"]["head_channels"] = 4
    c["buckets"] = [128, 256]
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(c))
    return path


def argv(workload: str, tmp_path: Path, *extra: str, seconds: float = 1.5) -> list[str]:
    kind = json.loads((BENCH / "workloads" / f"{workload}.json").read_text())["traffic"]
    out = ["--workload", workload, "--seed", "3000000019", "--seconds", str(seconds),
           "--device", "cpu", "--config-file", str(config_file(tmp_path)), *extra]
    for k, v in PARAMS[kind].items():
        out += ["--param", f"{k}={json.dumps(v)}"]
    return out


def run_cell(workload: str, tmp_path: Path, *extra: str) -> dict:
    """One CPU run of ``workload``: its result line (the JAX check left to
    the CLI test)."""
    import torch

    args = run.parse(argv(workload, tmp_path, *extra))
    cell, config, bench = run.load(args)
    with contextlib.redirect_stdout(io.StringIO()):
        return run.run_one(args, cell, config, bench, torch.device("cpu"))
