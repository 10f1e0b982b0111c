"""Run one cell of the benchmark once, from the root of a checkout:

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON line on standard output (``gpubench/bench.py``).
"""

import sys
import time

T_START = time.perf_counter()

from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the checkout's root

from gpubench.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
