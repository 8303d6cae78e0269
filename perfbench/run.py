"""Run one benchmark cell once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints progress and each number compared beside its limit on standard
error, and the result as one JSON object on the last line of standard
output. Exits non-zero, with no result, where there is no CUDA device (or
fewer than the cell asks for), where the program is not in the checkout,
or where JAX or the JAX package was loaded.
"""

import os
import sys
import time

T_START = time.perf_counter()


def _main() -> int:
    # the checkout's root, not this folder, is where packages are found
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from perfbench.harness import main

    return main(sys.argv[1:], T_START)


if __name__ == "__main__":
    sys.exit(_main())
