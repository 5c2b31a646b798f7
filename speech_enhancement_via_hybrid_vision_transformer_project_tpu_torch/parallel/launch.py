"""Start one worker process per local device of the mesh.

``launch(fn, args, nprocs=n, process_id=p)`` starts ``n`` processes with the
``spawn`` start method (CUDA cannot be used in a forked child); worker ``i``
calls ``fn(p * n + i, *args)``: its global rank, as the JAX multi-host
layout numbers them (``process_id`` x local devices + local device). ``fn``
and ``args`` are pickled, so ``fn`` is a module-level function of an
importable module. The call returns when every worker has exited 0. When a
worker fails, the others (which would wait in their next collective for
ever) are terminated and ``RuntimeError`` names it; at ``timeout`` seconds
all are terminated and ``TimeoutError`` is raised.
"""

from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection
import time
from typing import Callable, Optional, Sequence


def launch(fn: Callable, args: Sequence = (), *, nprocs: int, process_id: int = 0,
           timeout: Optional[float] = None) -> None:
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(process_id * nprocs + i, *args))
             for i in range(nprocs)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        running = list(procs)
        while running:
            wait = None if deadline is None else max(deadline - time.monotonic(), 0.0)
            mp.connection.wait([p.sentinel for p in running], timeout=wait)
            for p in [p for p in running if p.exitcode is not None]:
                running.remove(p)
                if p.exitcode != 0:
                    rank = process_id * nprocs + procs.index(p)
                    raise RuntimeError(f"worker rank {rank} exited with code {p.exitcode}")
            if running and deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"{len(running)} of {nprocs} workers still running after "
                                   f"{timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
