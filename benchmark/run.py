"""Run one benchmark cell once and print its result as the last line of
standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. See ``benchmark/README.md``.
"""

import time

T0 = time.perf_counter()  # the process's start, as near as this file sees it

import os  # noqa: E402
import sys  # noqa: E402

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    from benchmark.harness.runner import main

    sys.exit(main(sys.argv[1:], T0))
