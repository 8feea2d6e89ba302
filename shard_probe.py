"""Multi-card run of the port's sharded paths (`parallel/` of the port).

Run from the repository root on a machine with two or more CUDA cards:

    python3 shard_probe.py

It builds the training kernel, times the headline round trip on cuda:0
as the single-process reference (1 warm-up, 3 timed), then starts one
rank per card in an NCCL group (chip_smoke.py's phase-13 ranks, rank r on
cuda:r) at the bench configuration: the round trip on an (n, 1) mesh, the
ranks' front-end checksums, the kernel on each rank's rows (each on its
own card), the calibrated round trip on (n, 1) and (1, n) meshes, register
and shard_report, held by phase 13's checks to the reference. Prints every
card's name and power limit, one line per rank, and a JSON summary last.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import torch

import chip_smoke as cs


def main() -> int:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"shard_probe: needs two or more CUDA cards, found {n}",
              file=sys.stderr)
        return 1
    from gp_compressor_tpu_torch.cuda_kernels import sogp_train
    from gp_compressor_tpu_torch.utils import synthetic
    from gp_compressor_tpu_torch.workloads import compressor

    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60, check=True).stdout.strip()
    cs.say(f"cards: {cards.splitlines()}; torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    sogp_train.build()
    dev = torch.device("cuda", 0)
    ccfg = cs.bench_config()
    pts_np, cols_np = synthetic.room_cloud(n=cs.N_POINTS, seed=0)
    pts, cols = (torch.from_numpy(a).to(dev) for a in (pts_np, cols_np))
    valid = torch.ones(cs.N_POINTS, dtype=torch.bool, device=dev)
    compressor.compress_decompress(pts, cols, valid, ccfg)
    walls = []
    for _ in range(cs.TIMED_RUNS):
        t0 = time.perf_counter()
        comp, _ = compressor.compress_decompress(pts, cols, valid, ccfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    rmse = float(compressor.reconstruction_rmse(comp, ccfg))
    cs.say(f"single process on cuda:0 ({torch.cuda.get_device_name(0)}): "
           f"round trip walls {walls} s, rmse {rmse!r}")

    outdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "shard_probe")
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    t0 = time.perf_counter()
    ranks = cs.run_ranks(outdir, "nccl", n, True)
    shard = cs.hold_ranks(ranks, outdir, comp, rmse, ccfg,
                          "; ".join(cards.splitlines()))
    print(json.dumps({"ranks": n, "backend": "nccl",
                      "cards": cards.splitlines(),
                      "single_round_trip_s": walls,
                      "rank_round_trip_s": [r["walls"]["round_trip"]
                                            for r in ranks],
                      "kernel": shard, "wall_s": time.perf_counter() - t0}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
