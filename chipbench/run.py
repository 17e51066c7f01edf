"""Run one cell of the port's benchmark once:

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints the result as one JSON line, last on
standard output; see ``chipbench/README.md``.
"""
import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from chipbench.harness import main, setup_environment  # noqa: E402

if __name__ == "__main__":
    setup_environment()
    sys.exit(main(t_start=T_START))
