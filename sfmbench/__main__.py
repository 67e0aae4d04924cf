"""`python3 -m sfmbench --workload <name> --seed <n> --seconds <s> --trace <0|1>`."""

import time

T0 = time.perf_counter()

import sys  # noqa: E402

from .harness import main  # noqa: E402

sys.exit(main(sys.argv[1:], T0))
