"""On-card smoke run of the PyTorch/CUDA port (`gp_compressor_tpu_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

  0. device  — the card's name and power limit;
  1. build   — the fused SOGP training kernel from csrc/sogp_train.cu,
               with ptxas's registers and spills per instantiation (the
               32-slot ones must not spill);
  2. check   — the kernel against its plain PyTorch version on the card:
               its inline division against IEEE division, the four
               training regimes, the strict ones at 8 to 128 slots, the realistic one at 32 slots, a state with a NaN,
               the override row, and the bench banks the port's own front
               end makes (depth D=1 and RGB D=3); every launch must leave
               its input state unchanged;
  3. main    — compress_decompress at the bench configuration on a
               300k-point room cloud: 1 warm-up and 3 timed round trips,
               checked against the JAX package's CPU anchors, then a
               per-stage split;
  4. timing  — at the bench shapes, the kernel launch alone (state,
               outputs and hyperparameter row made beforehand) against
               the plain version (CUDA events, plain / kernel / kernel /
               plain), beside its bound; then train_gp with its set-up;
  5. profile — host wall of the front end's steps, then one round trip
               under torch.profiler (device busy time, idle share, kernel
               launches, host-side CUDA calls).

The last three lines of standard output are the kernels' JSON object, the
card's `nvidia-smi` name and power limit, and the result object.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time

import torch

N_POINTS = 300_000
# anchors from the JAX package's XLA path on this exact input and config
EXPECT_LEAVES = 1675
EXPECT_BANKED = 271_377
RMSE_MAX = 0.025
RMSE_JAX = 0.0208         # the JAX package's in-sample depth RMSE
TIMED_RUNS = 3
KERNEL_REPS = 20          # kernel launches per timed window
# the H100 SXM's peaks (NVIDIA's data sheet): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12


def bench_config():
    """The headline configuration (bench.py:41-66,168-195)."""
    from gp_compressor_tpu_torch import config as c
    return c.CompressorConfig(
        patch=c.PatchConfig(res=0.15, sz=20, max_patches=2048,
                            max_points_per_patch=256,
                            approx_sphere_moments=True,
                            bank_order="center_out"),
        depth_gp=c.GPConfig(capacity=30, slots=32, eps_tol=2.0),
        rgb_gp=dataclasses.replace(c.rgb_gp_config(slots=32, capacity=30),
                                   eps_tol=2.0))


def say(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls (CUDA events).
    A ~1 ms device sleep ahead of the start event lets the host queue the
    launches, so host overhead between them is not timed."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_report(log: str) -> dict:
    """{"D=.. R=..": {registers, stack, spill_stores, spill_loads}} per
    kernel instantiation, from nvcc's -Xptxas -v output."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            m = re.search(r"sogp_train_kernelILi(\d)ELi(\d)E", line)
            name = f"D={m[1]} R={m[2]}" if m else None
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, {}).update(stack=int(m[1]),
                                            spill_stores=int(m[2]),
                                            spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m[1])
    return out


def train_bound(cfg, X, mask, out) -> dict:
    """The least time the card could take for one training launch: the
    larger of its bytes (each input read once, each output written once)
    over the HBM rate and its operations over the fp32 rate. Operations
    are counted from this run's data: each valid row of a patch costs at
    most what a row with the patch's final BV count a costs (no bench
    patch reaches capacity, so counts only grow): 8a for k, 4a^2 for
    C k and Q k, (4 + 5D)a for the sums and alpha, 7(a+1)^2 for the
    rank-1 updates of C and Q, and ~40 for the scalars. `flops_dense` is
    the same count over all S slots, as a loop over every slot does it."""
    B, P, _ = X.shape
    S, D = cfg.slots, cfg.dout
    state = B * S * (2 * 4 + D * 4 + 2 * S * 4 + 1)
    nbytes = B * P * (2 * 4 + D * 4 + 1) + 2 * state + 7 * 4
    rows = mask.sum(1).double()

    def count(a):
        return float((rows * (8 * a + 4 * a ** 2 + (4 + 5 * D) * a
                              + 7 * (a + 1) ** 2 + 40)).sum())

    flops = count(out.active.sum(1).double())
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return {"bytes": nbytes, "flops": flops, "flops_dense": count(S),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def interval_union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s0, e0 in sorted(spans):
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def profile_phase(pts, cols, valid, ccfg, best_wall, kind, card):
    """Front-end step walls, then one profiled round trip."""
    from torch.profiler import ProfilerActivity, profile
    from gp_compressor_tpu_torch.geometry import patches, rotation, voxel
    from gp_compressor_tpu_torch.workloads import compressor

    pc = ccfg.patch
    steps = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t0
        return r

    grid = step("build_grid", lambda: voxel.build_grid(
        pts, valid, pc.res, pc.max_patches, pc.max_cells))
    M, cnt = step("sphere_moments", lambda: patches.sphere_moments(
        grid, pts, valid, pc))
    step("rotation_from_moment_batch", lambda: rotation.rotation_from_moment_batch(
        M, cnt, pc.min_points_for_rotation))
    step("project", lambda: compressor.project(pts, cols, valid, ccfg))
    say(f"[5] front-end steps (s, host wall) on {kind} ({card}): "
        f"{json.dumps(steps)}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        compressor.compress_decompress(pts, cols, valid, ccfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev_ev = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = interval_union_us((e.time_range.start, e.time_range.end)
                                for e in dev_ev)
    kernels = [e for e in dev_ev if not e.name.startswith(("Memcpy", "Memset"))]
    by_name = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    calls = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and \
                e.name.startswith(("cuda", "cu")) and not e.name.startswith(
                    "cudnn"):
            calls[e.name] = calls.get(e.name, 0) + 1
    res = {
        "profiled_wall_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "idle_share_profiled": 1.0 - busy_us / (wall * 1e6),
        "idle_share_vs_best_unprofiled": 1.0 - busy_us / (best_wall * 1e6),
        "device_kernels": len(kernels),
        "device_copies": len(dev_ev) - len(kernels),
        "host_cuda_calls": dict(sorted(calls.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": [[n[:80], c, us / 1e3] for n, (c, us) in top],
    }
    check(len(kernels) > 0, "the profiler saw no device kernel")
    say(f"[5] profiled round trip on {kind} ({card}): {json.dumps(res)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gp_compressor_tpu_torch.cuda_kernels import sogp_train
    from gp_compressor_tpu_torch.models import sparse_gp
    from gp_compressor_tpu_torch.testing import sogp_regimes
    from gp_compressor_tpu_torch.utils import synthetic
    from gp_compressor_tpu_torch.workloads import compressor

    # ---- 0. device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True,
                            text=True, timeout=60).stdout.strip()
    say(f"[0] device: {kind}; nvidia-smi: {card}; SM clock now, max: {clocks};"
        f" torch {torch.__version__} cuda {torch.version.cuda}; count "
        f"{torch.cuda.device_count()}")

    # ---- 1. build
    sogp_train.build()
    info = sogp_train.BUILD_INFO
    say(f"[1] built {info['path']} in {info['seconds']:.2f} s")
    ptxas = ptxas_report(info["ptxas"])
    say(f"[1] ptxas per instantiation: {json.dumps(ptxas)}")
    for d in (1, 3):
        rep = ptxas.get(f"D={d} R=1", {})
        check(rep.get("spill_stores") == 0 and rep.get("spill_loads") == 0,
              f"the 32-slot D={d} kernel spills or is missing: {rep}")

    # ---- 2. kernel against its plain version
    def bits(t):
        return t.contiguous().view(torch.uint8)

    def both(cfg, X, Y, M, init=None, **kw):
        kp = sogp_regimes.params(dev)
        if init is None:
            init = sparse_gp.init_batch(cfg, X.shape[0], device=dev)
        before = [a.clone() for a in init]
        out = sogp_train.add_points_batch_cuda(kp, cfg, init, X, Y, M, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(bits(a), bits(b)) for a, b in zip(before, init)),
              "the kernel changed its input state")
        ref = sogp_train.add_points_batch_plain(kp, cfg, init, X, Y, M, **kw)
        torch.cuda.synchronize()
        return ref, out

    def on_dev(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    def run(name, rule=None, **kw):
        cfg, X, Y, M = sogp_regimes.regime(name, **kw)
        X, Y, M = on_dev(X, Y, M)
        ref, out = both(cfg, X, Y, M)
        return sogp_regimes.compare(rule or name, ref, out, X, Y, M)

    a, b = on_dev(*sogp_regimes.division_cases())
    ref = a / b
    nan = torch.isnan(ref)
    for q in sogp_train.inline_division(a, b):
        check(torch.equal(nan, torch.isnan(q))
              and torch.equal(bits(q[~nan]), bits(ref[~nan])),
              "the kernel's inline division differs from IEEE a / b")
    say(f"[2] inline division: bit-equal to IEEE a / b on {a.numel()} pairs")
    del a, b, ref, nan, q

    max_err = 0.0
    for name in sogp_regimes.REGIMES:
        res = run(name)
        if name.startswith("strict"):
            max_err = max(max_err, res["max_abs_err"])
        say(f"[2] {name}: {json.dumps(res)}")
    for name in ("strict_d1", "strict_d3"):
        errs = {}
        for slots in sogp_regimes.SLOT_SWEEP:
            errs[slots] = run(name, slots=slots)["max_abs_err"]
        max_err = max(max_err, *errs.values())
        say(f"[2] {name} over slots, max |d|: {json.dumps(errs)}")
    res = run("realistic", slots=32)
    say(f"[2] realistic at 32 slots: {json.dumps(res)}")

    cfg, first, second = sogp_regimes.nan_case()
    first, second = on_dev(*first), on_dev(*second)
    kp = sogp_regimes.params(dev)
    init = sparse_gp.init_batch(cfg, first[0].shape[0], device=dev)
    seeded = sogp_train.add_points_batch_plain(kp, cfg, init, *first)
    ref, out = both(cfg, *second, init=sogp_regimes.poison(seeded))
    res = sogp_regimes.compare("nan", ref, out, *second)
    max_err = max(max_err, res["max_abs_err"])
    say(f"[2] NaN in patch {sogp_regimes.NAN_PATCH}'s C: {json.dumps(res)}")

    cfg, X, Y, M = sogp_regimes.regime("geometric")
    X, Y, M = on_dev(X, Y, M)
    init = sparse_gp.init_batch(cfg, X.shape[0], device=dev)
    t = lambda v: torch.tensor(v, device=dev)
    a = sogp_train.add_points_batch_cuda(kp, cfg, init, X, Y, M)
    b = sogp_train.add_points_batch_cuda(kp, cfg, init, X, Y, M,
                                         geom=(t(0.05), t(3.0), t(1e-2)))
    torch.cuda.synchronize()
    check(all(torch.equal(u, v) for u, v in zip(a, b)),
          "override row differs from the static config")
    say("[2] override row: bit-equal to the static config")

    ccfg = bench_config()
    pts_np, cols_np = synthetic.room_cloud(n=N_POINTS, seed=0)
    pts, cols = on_dev(pts_np, cols_np)
    valid = torch.ones(N_POINTS, dtype=torch.bool, device=dev)
    batch = compressor.project(pts, cols, valid, ccfg)
    dkp, ckp = compressor.default_params(ccfg, dev)
    # no bench patch reaches capacity, so there is no deletion churn: the
    # strict rule plus a maximum prediction gap < 1e-3
    bounds = {}
    for gpcfg, kp, Y in ((ccfg.depth_gp, dkp, batch.y),
                         (ccfg.rgb_gp, ckp, batch.rgb)):
        out = compressor.train_gp(batch, gpcfg, kp, Y, use_kernel=True)
        torch.cuda.synchronize()
        ref = compressor.train_gp(batch, gpcfg, kp, Y, use_kernel=False)
        torch.cuda.synchronize()
        bounds[gpcfg.dout] = train_bound(gpcfg, batch.X, batch.mask, out)
        sizes = torch.bincount(sparse_gp.size(out), minlength=4)[:4].tolist()
        say(f"[2] bench banks D={gpcfg.dout}: kernel BV-count histogram "
            f"(0..3): {sizes}")
        check(int(sparse_gp.size(ref).max()) < gpcfg.capacity,
              "a bench patch reached capacity: the strict rule does not apply")
        res = sogp_regimes.compare("bench", ref, out, batch.X, Y, batch.mask,
                                   kp=kp, s20=gpcfg.s20)
        max_err = max(max_err, res["max_abs_err"])
        say(f"[2] bench banks D={gpcfg.dout}: {json.dumps(res)}")

    # ---- 3. the main path
    def round_trip():
        comp, out = compressor.compress_decompress(pts, cols, valid, ccfg)
        torch.cuda.synchronize()
        return comp, out

    round_trip()                                   # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    sogp_train.LAUNCHES = 0
    times = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        comp, out = round_trip()
        times.append(time.perf_counter() - t0)
    launches = sogp_train.LAUNCHES
    peak = torch.cuda.max_memory_allocated(dev)
    check(launches == 2 * TIMED_RUNS,
          f"kernel launches {launches}, expected {2 * TIMED_RUNS}")
    n_leaves = int(comp.patch.n_leaves)
    banked = int(comp.patch.mask.sum())
    rmse = float(compressor.reconstruction_rmse(comp, ccfg))
    world, colors, pvalid = out[0], out[1], out[2]
    G = ccfg.patch.sz ** 2
    say(f"[3] n_leaves {n_leaves}, banked {banked}, rmse {rmse:.6f} m, "
        f"emitted {int(pvalid.sum())} points")
    check(n_leaves == EXPECT_LEAVES, f"n_leaves {n_leaves} != {EXPECT_LEAVES}")
    check(abs(banked - EXPECT_BANKED) <= 1e-3 * EXPECT_BANKED,
          f"banked {banked} not within 0.1% of {EXPECT_BANKED}")
    check(math.isfinite(rmse) and rmse <= RMSE_MAX,
          f"rmse {rmse} above {RMSE_MAX}")
    check(abs(rmse - RMSE_JAX) <= 0.02 * RMSE_JAX,
          f"rmse {rmse} not within 2% of the JAX package's {RMSE_JAX}")
    check(world.shape == (2048 * G, 3) and colors.shape == (2048 * G, 3),
          "decompress output shape")
    check(bool(torch.isfinite(world[pvalid]).all())
          and bool(torch.isfinite(colors).all()), "non-finite output")
    best = min(times)
    say(f"[3] round trip on {kind} ({card}): wall {times} s, best "
        f"{best:.4f} s = {N_POINTS / best:.1f} points/s; kernel launches "
        f"{launches} in {TIMED_RUNS} runs; peak memory {peak} B")

    # per-stage split, synchronised between stages
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return r

    batch = stage("project", lambda: compressor.project(pts, cols, valid, ccfg))
    dstates = stage("depth_train", lambda: compressor.train_gp(
        batch, ccfg.depth_gp, dkp, batch.y))
    cstates = stage("rgb_train", lambda: compressor.train_gp(
        batch, ccfg.rgb_gp, ckp, batch.rgb))
    dstates, cstates, n_bad_d, n_bad_c = stage(
        "sanitize", lambda: compressor.sanitize(
            batch, ccfg, dstates, cstates, dkp, ckp, ccfg.depth_gp.s20))
    comp = compressor.CompressedCloud(batch, dstates, cstates)
    stage("decompress", lambda: compressor.decompress(comp, ccfg))
    say(f"[3] stages (s) on {kind} ({card}): {json.dumps(stages)}; "
        f"sanitize resets depth {int(n_bad_d)} rgb {int(n_bad_c)}")

    # ---- 4. kernel time against plain-version time at the bench shapes
    timing = {}
    for gpcfg, kp, Y in ((ccfg.depth_gp, dkp, batch.y),
                         (ccfg.rgb_gp, ckp, batch.rgb)):
        init = sparse_gp.init_batch(gpcfg, batch.mask.shape[0], device=dev)
        out = sparse_gp.SOGPState(*[torch.empty_like(a) for a in init])
        row = sogp_train.hyper_row(kp, gpcfg, dev)
        kern = lambda: sogp_train.launch(gpcfg, init, out, batch.X, Y,
                                         batch.mask, row)
        plain = lambda: sogp_train.add_points_batch_plain(
            kp, gpcfg, init, batch.X, Y, batch.mask)
        train = lambda: compressor.train_gp(batch, gpcfg, kp, Y,
                                            use_kernel=True)
        kern(), train()
        torch.cuda.synchronize()
        p1, k1, k2, p2 = (event_ms(plain, 2), event_ms(kern, KERNEL_REPS),
                          event_ms(kern, KERNEL_REPS), event_ms(plain, 2))
        t1 = event_ms(train, KERNEL_REPS)
        bound = bounds[gpcfg.dout]
        ms = (k1 + k2) / 2
        # the longest patch's rows are one dependent chain: the launch
        # cannot end before it does
        rows_max = int(batch.mask.sum(1).max())
        timing[gpcfg.dout] = (ms, (p1 + p2) / 2, bound)
        say(f"[4] D={gpcfg.dout} B=2048 P=256 S=32 on {kind} ({card}): "
            f"kernel {k1:.4f}/{k2:.4f} ms per launch, plain {p1:.4f}/"
            f"{p2:.4f} ms, train_gp (init + row + launch) {t1:.4f} ms; "
            f"bound {bound['bound_ms'] * 1e3:.2f} us by {bound['bound_by']} "
            f"({bound['bytes']} B, {bound['flops']:.4g} FLOP needed, "
            f"{bound['flops_dense']:.4g} dense), share of "
            f"bound {bound['bound_ms'] / ms:.4f}; longest patch {rows_max} "
            f"valid rows, {ms * 1e3 / rows_max:.3f} us per row of it")

    # ---- 5. where the round trip's time goes
    profile_phase(pts, cols, valid, ccfg, best, kind, card)

    # one D=1 and one D=3 launch per round trip: ms and plain_ms are their sum
    kernels = [{
        "name": "sogp_train",
        "route": "cuda",
        "source": "gp_compressor_tpu_torch/csrc/sogp_train.cu",
        "replaces": "gp_compressor_tpu/pallas_kernels/sogp_train.py:327",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timing[1][0] + timing[3][0],
        "plain_ms": timing[1][1] + timing[3][1],
        "bound_ms": timing[1][2]["bound_ms"] + timing[3][2]["bound_ms"],
        "bound_by": timing[1][2]["bound_by"],
        "library_ms": None,     # no PyTorch call runs the online SOGP loop
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
