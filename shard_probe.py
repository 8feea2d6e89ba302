"""Multi-card run of the port's sharded paths (`parallel/` of the port).

Run from the repository root on a machine with CUDA cards:

    python3 shard_probe.py

It builds the training kernel, times the headline round trip on cuda:0
as the single-process reference (1 warm-up, 3 timed, then its walls and
peak memory by stage) and runs the single process's front end on the
seeds phase 13 checks, then starts one rank per card in an NCCL group
(chip_smoke.py's phase-13 ranks, rank r on cuda:r; with one card, one
rank: the sharded path's own cost, with no other rank to wait for) at
the bench configuration: each rank takes its block of the cloud's points, runs the
round trip on an (n, 1) mesh, its walls by stage, the front end of the
other seeds, the kernel on its rows (each on its own card), the
calibrated round trip on (n, 1) and (1, n) meshes, register and
shard_report (its point rows and peak memory by stage), held by phase
13's checks to the reference. One front end of the single process and of
every rank runs under torch.profiler (`chip_smoke.front_end_trace`): the
script prints their spans (steps and collectives) and host syncs by the
port's function side by side. Prints every card's name and power limit,
one line per rank, and a JSON summary last.
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
    if n < 1:
        print("shard_probe: needs a CUDA card", file=sys.stderr)
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
    # walls by stage TIMED_RUNS times; peak memory by stage, and what was
    # allocated when the stage began, on the first
    stages = {"front_end": [], "training": [], "decompress": []}
    peaks, starts = {}, {}

    def stage(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        starts.setdefault(name, torch.cuda.memory_allocated(dev))
        r, wall = cs.timed(fn)
        stages[name].append(wall)
        peaks.setdefault(name, torch.cuda.max_memory_allocated(dev))
        return r

    for _ in range(cs.TIMED_RUNS):
        batch = stage("front_end",
                      lambda: compressor.project(pts, cols, valid, ccfg))
        trained = stage("training", lambda: compressor.train(batch, ccfg))
        stage("decompress", lambda: compressor.decompress(trained, ccfg))
    del batch, trained
    cs.say(f"single process on cuda:0 ({torch.cuda.get_device_name(0)}): "
           f"round trip walls {walls} s, rmse {rmse!r}; walls by stage (s) "
           f"{json.dumps(stages)}, peak bytes by stage {json.dumps(peaks)}, "
           f"allocated at its start {json.dumps(starts)}")
    single_fe = cs.single_front_ends(ccfg, dev)
    trace = cs.front_end_trace(
        lambda: compressor.project(pts, cols, valid, ccfg))
    cs.say(f"single process's front end traced: {json.dumps(trace)}")

    outdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "shard_probe")
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    t0 = time.perf_counter()
    ranks = cs.run_ranks(outdir, "nccl", n, True)
    shard = cs.hold_ranks(ranks, outdir, comp, rmse, ccfg,
                          "; ".join(cards.splitlines()), single_fe)
    # the front end's spans and host syncs, one process against each rank
    traces = [r["front_end_trace"] for r in ranks]
    keys = lambda part: sorted(set(trace[part]).union(
        *(t[part] for t in traces)))
    cs.say("front end traced, one process | rank 0..n-1: wall ms "
           f"{trace['traced_wall_ms']:.2f} | "
           f"{[round(t['traced_wall_ms'], 2) for t in traces]}; launches "
           f"{trace['launches']} | {[t['launches'] for t in traces]}; "
           f"sync ms {trace['sync_ms']:.3f} | "
           f"{[round(t['sync_ms'], 3) for t in traces]}")
    for part, what in (("spans", "[calls, ms, launches]"),
                       ("syncs", "[count, ms held]")):
        for k in keys(part):
            cs.say(f"  {part[:-1]} {k} {what}: {trace[part].get(k)} | "
                   f"{[t[part].get(k) for t in traces]}")
    print(json.dumps({"ranks": n, "backend": "nccl",
                      "cards": cards.splitlines(),
                      "single_round_trip_s": walls,
                      "single_stage_s": stages,
                      "single_stage_peak_bytes": peaks,
                      "single_stage_start_bytes": starts,
                      "rank_round_trip_s": [r["walls"]["round_trip"]
                                            for r in ranks],
                      "rank_stage_s": [r["walls"]["stages"] for r in ranks],
                      "rank_stage_peak_bytes": [
                          r["shard_report"]["stage_peak_bytes"]
                          for r in ranks],
                      "rank_stage_start_bytes": [
                          r["shard_report"]["stage_start_bytes"]
                          for r in ranks],
                      "single_front_end_trace": trace,
                      "rank_front_end_trace": traces,
                      "kernel": shard, "wall_s": time.perf_counter() - t0}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
