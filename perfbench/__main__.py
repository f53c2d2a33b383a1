"""``python -m perfbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell (see ``run.py``)."""

import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import sys

    from perfbench.run import main

    sys.exit(main(sys.argv[1:], T_START))
