"""Readings that the limits of `correct` are set from, on the card.

    python3 portbench/control.py --workload compress.stream \
        --seeds 1 2 3 ... --control-seeds 1 2 3 --seconds 3

For each of --seeds, in one process: the cell's set-up, a short window at
the cell's own load, and the comparison with the reference, as a run
makes them (the program's sound readings, whose largest sets each limit's
lower reading). For each of --control-seeds: a whole run of the cell
(`runner.run_cell`, the same short window) with the control in the
program's place: the reference computed in the precision below the
configuration's (bfloat16 for float32) on every request the run checks
(its smallest readings set the upper reading; its `correct` has to come
out false). One JSON line per seed. The benchmark's own runs never run
this.
"""

import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from portbench.harness import runner, spec  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    pieces = spec.cell(spec.benchmark(), args.workload)
    Entry = spec.entry_class(pieces["traffic"]["entry"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        e = Entry(pieces["config"], pieces["traffic"], seed, device)
        e.setup()
        win = runner.measure(e, args.seconds, device)
        e.end_window()
        print(json.dumps({"seed": seed, "kind": "program",
                          "requests": win.requests,
                          "numbers": e.check(None),
                          "wall_s": time.perf_counter() - t0}), flush=True)
        del e
    low = runner.CONTROL_DTYPE[pieces["config"]["dtype"]]
    Control = runner.control_entry(Entry, low)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        r = runner.run_cell(pieces, seed, args.seconds, False, device, t0,
                            entry_class=Control)
        print(json.dumps({"seed": seed, "kind": "control",
                          "dtype": str(low), "correct": r["correct"],
                          "compared": Control.compared,
                          "checks": r["checks"],
                          "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
