"""`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`: one run of one cell on the CUDA card of this machine.

Prints the compared numbers beside their limits as the last lines of
standard error, and one JSON object as the last line of standard output.
Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), or when a module of JAX or of the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import sys

# top-level module names the run may not load: JAX, its libraries, and
# the JAX package the port was made from (compared whole, so the port's
# own name, which begins with the JAX package's, does not match)
FORBIDDEN = ("jax", "jaxlib", "flax", "gp_compressor_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is in FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    import torch
    torch.set_num_threads(1)

    from portbench.harness import runner, spec

    pieces = spec.cell(spec.benchmark(), args.workload)
    chips = int(pieces["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = runner.run_cell(pieces, args.seed, args.seconds,
                             bool(args.trace), device, t_start)
    bad = forbidden_modules()
    if bad:
        print("portbench: modules of JAX or of the JAX package are loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
