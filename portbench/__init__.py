"""The port's benchmark: one cell a command, driven by the files it names.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

See ``portbench/README.md``.
"""

import time

# process start, as near as Python lets a module see it: set-up is timed
# from here to the window's first request or step
T_START = time.perf_counter()
