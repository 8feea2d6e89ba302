"""Readings of the mapping cell under a fault, on the card: the upper
readings of the limits that the control cannot give (it replaces only the
frames the check compares, so it never moves the pose or fills the map).

    python3 portbench/map_fault.py --fault eight_steps --seeds 1 2 3 \
        --seconds 51

For each seed, a whole run of `map.stream` (`runner.run_cell`) with the
configuration changed as the fault says; one JSON line per seed with the
run's `correct`, its checks ({name: [reading, limit]}) and its requests.

  * eight_steps  the JAX package's bench registration (bench.py:617: at
        most 8 steps, at least 2, no frame dropped), which cannot follow
        1.0 deg a frame: 8 iRprop- steps move an axis 16.5 mrad at most;
  * small_map    half the configuration's leaves, fewer than the loop
        needs.

The benchmark's own runs never run this.
"""

import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from portbench.harness import runner, spec  # noqa: E402

CELL = "map.stream"


def eight_steps(pieces: dict):
    pieces["config"]["registration"].update(min_steps=2, max_steps=8)
    pieces["config"]["mapping"]["drop_on_reg_cap"] = False


def small_map(pieces: dict):
    pieces["config"]["patch"]["max_patches"] //= 2


FAULTS = {"eight_steps": eight_steps, "small_map": small_map}


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        pieces = spec.cell(spec.benchmark(), CELL)
        FAULTS[args.fault](pieces)
        r = runner.run_cell(pieces, seed, args.seconds, False, device, t0)
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "correct": r["correct"],
                          "requests": r["attempted"], "checks": r["checks"],
                          "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
