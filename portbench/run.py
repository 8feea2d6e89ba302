"""Run one cell of the port's benchmark once; see portbench/harness/cli.py.

    python3 portbench/run.py --workload compress.stream --seed 7 \
        --seconds 30 --trace 0

Run from the root of a checkout of the repository: the program under
test is the package `gp_compressor_tpu_torch` beside this folder.
"""

import time

T_START = time.perf_counter()     # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402


def main() -> int:
    # one process with few threads: the program's host thread, the CUDA
    # runtime's threads and torch's own on two fixed cores of those this
    # process may use, so that its launch chain does not migrate
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-2:])
    # the checkout's root in place of this folder, so that `portbench`
    # and the program import as packages
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from portbench.harness import cli
    return cli.main(sys.argv[1:], T_START)


if __name__ == "__main__":
    sys.exit(main())
