"""Card-only tests: the fused SOGP training kernel against its plain
PyTorch version, on the card, for the four training regimes of
tests/test_pallas_sogp.py, the strict ones over state sizes of 8 to 128
slots, the realistic one at 32 slots, a state with a NaN, the bench
banks (whose 32-slot instantiations must not spill) and small banks at the calibrated hyperparameters (rules in
gp_compressor_tpu_torch/testing/sogp_regimes.py), the mapping call site
(the small mapping case's banks trained from the map's non-empty states,
and one state non-zero off its active block, which takes the kernel's
dense loop), and the kernel's inline division against IEEE division;
then the Bayesian layer on the card against the CPU with the same draws
in float64 (a NUTS transition, HMC steps, ADVI steps, an SMC refinement
step against the small mapping case's map), compress_calibrated
(method="hmc") launching the kernel twice, and the MAP ascent's CUDA
graph against the eager ascent (eager, then capture, then replay, at the
benchmark's shapes; two banks and starts through one graph; gated and
failed factorizations); OMP's CUDA graph against the eager encoding
(eager, then capture, then replay, bit for bit at the benchmark's depth
and colour shapes with a singular Gram; two problems through one graph;
no synchronising call in a replay, none per word eager; K-SVD runs whose
encodings replay after the first two, equal to the runs that began
eager, and a compress that replays them all); the
K-SVD codec (OMP and one
outer sweep on the card against the CPU in float64 with the same draws,
one stop-test read per sweep; the atom block kernel against the dense
plain version at the depth and colour shapes, with atoms of no, one and
every user, padding and non-finite rows, a singular Gram, and every
block of a small compress) and ICP on the card against the CPU; the
native IO library's build on the card's machine, and the command line
on its default device (the card).

This file imports no JAX. With tests/test_torch_gpu_rows.py (the bench
rows against the JAX package's anchors), tests/test_torch_gpu_cli.py (the
command line against JAX's) and tests/test_torch_gpu_sharded.py (the
sharded paths on the card) it is the port's check on the card; run them
on a machine with a CUDA card:

    python -m pytest tests/test_torch_gpu*.py -m gpu --noconftest -q

(`--noconftest` because tests/conftest.py imports JAX.) Without a card
every test skips.
"""

import pytest
import torch

from gp_compressor_tpu_torch.cuda_kernels import sogp_train
from gp_compressor_tpu_torch.models import sparse_gp
from gp_compressor_tpu_torch.testing import sogp_regimes
from gp_compressor_tpu_torch.utils import profiling
from torch_gpu_case import (bench, bench_cloud, count,  # noqa: F401
                            count_syncs, dev, launches, same_block,
                            zero_off_active)

pytestmark = pytest.mark.gpu


def _on(dev, *arrays):
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


def _inputs(dev, name, **kw):
    cfg, X, Y, M = sogp_regimes.regime(name, **kw)
    return (cfg,) + _on(dev, X, Y, M)


def _bits(t):
    return t.contiguous().view(torch.uint8)


def _both(dev, cfg, X, Y, M, init=None, kp=None, **kw):
    kp = sogp_regimes.params(dev) if kp is None else kp
    if init is None:
        init = sparse_gp.init_batch(cfg, X.shape[0], device=dev)
    n0 = launches()
    out = sogp_train.add_points_batch_cuda(kp, cfg, init, X, Y, M, **kw)
    torch.cuda.synchronize()
    assert launches() == n0 + 1
    ref = sogp_train.add_points_batch_plain(kp, cfg, init, X, Y, M, **kw)
    return ref, out


@pytest.mark.parametrize("name", sogp_regimes.REGIMES)
def test_kernel_matches_plain(dev, name):
    cfg, X, Y, M = _inputs(dev, name)
    ref, out = _both(dev, cfg, X, Y, M)
    sogp_regimes.compare(name, ref, out, X, Y, M)


@pytest.mark.parametrize("slots", sogp_regimes.SLOT_SWEEP)
@pytest.mark.parametrize("name", ["strict_d1", "strict_d3"])
def test_strict_regimes_over_slot_counts(dev, name, slots):
    """Partial warps and 1 to 4 slots per lane."""
    cfg, X, Y, M = _inputs(dev, name, slots=slots)
    ref, out = _both(dev, cfg, X, Y, M)
    sogp_regimes.compare(name, ref, out, X, Y, M)


@pytest.mark.parametrize("rows,rule", [(40, "strict"), (96, "strict"),
                                       (160, "calibrated")])
@pytest.mark.parametrize("name", ["strict_d1", "strict_d3"])
def test_many_bvs_at_101_slots(dev, name, rows, rule):
    """gp-accuracy's state size with up to 90 BVs (a lane's slots 1-3
    active) by the strict rule, and with capacity deletions at 100 BVs,
    where float32 can flip a deletion choice, by the calibrated rule."""
    cfg, X, Y, M = _inputs(dev, name, slots=101, capacity=100, points=rows)
    ref, out = _both(dev, cfg, X, Y, M)
    assert int(sparse_gp.size(ref).max()) > 32
    sogp_regimes.compare(rule, ref, out, X, Y, M)


def test_realistic_regime_at_32_slots(dev):
    """Capacity churn at the bench's state size: deletions run through the
    kernel's active-slot downdate."""
    cfg, X, Y, M = _inputs(dev, "realistic", slots=32)
    ref, out = _both(dev, cfg, X, Y, M)
    sogp_regimes.compare("realistic", ref, out, X, Y, M)


def test_nan_state_matches_plain(dev):
    """A NaN in one patch's active C: the kernel takes its dense loop and
    spreads the NaN as the plain version does."""
    cfg, first, second = sogp_regimes.nan_case()
    first, second = _on(dev, *first), _on(dev, *second)
    kp = sogp_regimes.params(dev)
    seeded = sogp_train.add_points_batch_plain(
        kp, cfg, sparse_gp.init_batch(cfg, first[0].shape[0], device=dev),
        *first)
    ref, out = _both(dev, cfg, *second, init=sogp_regimes.poison(seeded))
    sogp_regimes.compare("nan", ref, out, *second)


def test_input_state_unchanged(dev):
    """The kernel writes a new state and leaves its input as it was."""
    cfg, X, Y, M = _inputs(dev, "realistic", slots=32)
    kp = sogp_regimes.params(dev)
    init = sogp_train.add_points_batch_plain(
        kp, cfg, sparse_gp.init_batch(cfg, X.shape[0], device=dev),
        X[:, :40], Y[:, :40], M[:, :40])
    before = [a.clone() for a in init]
    out = sogp_train.add_points_batch_cuda(kp, cfg, init, X, Y, M)
    torch.cuda.synchronize()
    for a, b in zip(before, init):
        assert torch.equal(_bits(a), _bits(b))
    assert not torch.equal(out.C, init.C)


@pytest.mark.parametrize("dout", [1, 3])
def test_bench_banks_match_plain(dev, bench, dout):
    """The bench banks never reach capacity: the `bench` rule."""
    ccfg, batch, (dkp, ckp) = bench
    gpcfg, kp, Y = ((ccfg.depth_gp, dkp, batch.y) if dout == 1
                    else (ccfg.rgb_gp, ckp, batch.rgb))
    ref, out = _both(dev, gpcfg, batch.X, Y, batch.mask, kp=kp)
    assert int(sparse_gp.size(ref).max()) < gpcfg.capacity
    sogp_regimes.compare("bench", ref, out, batch.X, Y, batch.mask, kp=kp,
                         s20=gpcfg.s20)


@pytest.fixture(scope="module")
def map_banks(dev):
    """The small mapping case on the card: the map after scan 0 (trained
    by the kernel), then the main-bank inputs of scan 1's insert, whose
    input states are the map's non-empty states."""
    import numpy as np

    from gp_compressor_tpu_torch import config
    from gp_compressor_tpu_torch.testing import mapping_case as case
    from gp_compressor_tpu_torch.workloads import mapping

    cfg = case.compressor_config(config, torch.float32)
    mc = case.mapping_config(config)
    sc = [tuple(torch.from_numpy(a).to(dev) for a in s)
          for s in case.scans(np.float32)]
    st = mapping.map_init(cfg, mc, *case.BOX, pending_capacity=case.PENDING,
                          device=dev)
    st, _ = mapping.map_insert(st, *sc[0], cfg, mc, 1)
    captured = []
    train = sogp_train.add_points_batch_cuda

    def spy(kp, gcfg, states, X, Y, mask, **kw):
        captured.append((kp, gcfg, states, X, Y, mask, kw))
        return train(kp, gcfg, states, X, Y, mask, **kw)

    sogp_train.add_points_batch_cuda = spy
    try:
        mapping.map_insert(st, *sc[1], cfg, mc, mc.min_points_new_patch)
    finally:
        sogp_train.add_points_batch_cuda = train
    return captured[:2]                      # main bank, D=1 and D=3


def _mapping_compare(dev, kp, gcfg, init, X, Y, M, kw):
    ref, out = _both(dev, gcfg, X, Y, M, init=init, kp=kp, **kw)
    s20 = kw.get("s20")
    return sogp_regimes.compare("calibrated", ref, out, X, Y, M, kp=kp,
                                s20=gcfg.s20 if s20 is None else s20)


@pytest.mark.parametrize("call", [0, 1], ids=["depth", "rgb"])
def test_mapping_banks_from_map_states_match_plain(dev, map_banks, call):
    """The kernel at the mapping call site, starting from the map's
    states (the `calibrated` rule: the small map's patches churn at
    capacity 12)."""
    kp, gcfg, states, X, Y, M, kw = map_banks[call]
    used = M.any(1)
    assert float(states.active.sum(1)[used].double().mean()) > 1.0
    _mapping_compare(dev, kp, gcfg, states, X, Y, M, kw)


def test_state_nonzero_off_active_block_takes_dense_loop(dev, map_banks):
    """A patch whose C is non-zero between an active and an inactive slot
    runs the kernel's dense loop, which holds the plain version."""
    kp, gcfg, states, X, Y, M, kw = map_banks[0]
    n = states.active.sum(1)
    b = int(torch.nonzero((n > 0) & (n < gcfg.slots) & M.any(1))[0])
    i = int(torch.nonzero(states.active[b])[0])
    j = int(torch.nonzero(~states.active[b])[0])
    C = states.C.clone()
    C[b, i, j] = C[b, j, i] = 1e-3 * float(states.C[b].abs().max())
    init = states._replace(C=C)
    assert not bool(zero_off_active(init)[b])
    assert bool(zero_off_active(states)[b])
    _mapping_compare(dev, kp, gcfg, init, X, Y, M, kw)


@pytest.mark.parametrize("dout", [1, 3])
def test_calibrated_regime_matches_plain(dev, dout):
    """At the calibrated hyperparameters patches fill to capacity 30 and
    delete on most rows: the `calibrated` rule."""
    cfg, *arrays = sogp_regimes.calibrated_case(dout)
    X, Y, M = _on(dev, *arrays)
    kp = sogp_regimes.calibrated_params(dev)
    ref, out = _both(dev, cfg, X, Y, M, kp=kp, s20=sogp_regimes.CAL_S20,
                     eps_tol=sogp_regimes.CAL_EPS)
    assert float(out.active.sum(1).double().mean()) > 0.95 * cfg.capacity
    sogp_regimes.compare("calibrated", ref, out, X, Y, M, kp=kp,
                         s20=sogp_regimes.CAL_S20)


def test_inline_division_is_ieee(dev):
    """The kernel's inline division, per element and as the row's fast
    paths with their fix-up, equals IEEE a / b bit for bit (NaN where
    NaN) on edge cases and random operands."""
    a, b = (torch.from_numpy(v).to(dev)
            for v in sogp_regimes.division_cases())
    ref = a / b
    for q in sogp_train.inline_division(a, b):
        nan = torch.isnan(ref)
        assert torch.equal(nan, torch.isnan(q))
        assert torch.equal(_bits(q[~nan]), _bits(ref[~nan]))


def _ptxas_report(log: str) -> dict:
    """{"D=.. R=..": {registers, stack, spill_stores, spill_loads}} per
    instantiation of the training kernel, from nvcc's -Xptxas -v output."""
    import re

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


@pytest.mark.parametrize("dout", [1, 3])
def test_32_slot_kernels_do_not_spill(dev, dout):
    """The bench's instantiations (32 slots: one per lane) keep the row
    loop in registers: ptxas reports no spill stores or loads."""
    sogp_train.build()
    rep = _ptxas_report(sogp_train.BUILD_INFO["ptxas"]).get(f"D={dout} R=1")
    assert rep is not None, "the 32-slot kernel is missing"
    assert rep.get("spill_stores") == 0 and rep.get("spill_loads") == 0, rep


def test_override_row_matches_static_config(dev):
    cfg, X, Y, M = _inputs(dev, "geometric")
    geom = tuple(torch.tensor(v, device=dev) for v in (0.05, 3.0, 1e-2))
    kp = sogp_regimes.params(dev)
    init = sparse_gp.init_batch(cfg, X.shape[0], device=dev)
    a = sogp_train.add_points_batch_cuda(kp, cfg, init, X, Y, M)
    b = sogp_train.add_points_batch_cuda(kp, cfg, init, X, Y, M, geom=geom)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_128_slots_use_opt_in_shared_memory(dev):
    cfg, X, Y, M = _inputs(dev, "strict_d3", slots=128, capacity=100)
    ref, out = _both(dev, cfg, X, Y, M)
    sogp_regimes.compare("strict_d3", ref, out, X, Y, M)


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    cfg, X, Y, M = _inputs(dev, "strict_d1")
    kp = sogp_regimes.params(dev)
    init = sparse_gp.init_batch(cfg, X.shape[0], device=dev)
    call = sogp_train.add_points_batch_cuda
    with pytest.raises(ValueError):          # not contiguous
        call(kp, cfg, init, X.transpose(0, 1).contiguous().transpose(0, 1),
             Y, M)
    with pytest.raises(TypeError):           # not float32
        call(kp, cfg, init, X.double(), Y, M)
    with pytest.raises(ValueError):          # state on another device
        call(kp, cfg, sparse_gp.init_batch(cfg, X.shape[0], device="cpu"),
             X, Y, M)
    big = sogp_regimes.regime("strict_d1", slots=129, capacity=100)[0]
    with pytest.raises(ValueError):          # more slots than the kernel takes
        call(kp, big, sparse_gp.init_batch(big, X.shape[0], device=dev),
             X, Y, M)


@pytest.fixture(scope="module")
def small_map():
    """The small mapping case's map after scan 0 (CPU, float64), the moved
    scan 1 and the stream's hyperparameters."""
    from gp_compressor_tpu_torch import config as c
    from gp_compressor_tpu_torch.ops.kernels import RBFParams
    from gp_compressor_tpu_torch.testing import mapping_case as case
    from gp_compressor_tpu_torch.workloads import mapping

    cfg = case.compressor_config(c, torch.float64)
    mcfg = case.mapping_config(c)
    st = mapping.map_init(cfg, mcfg, *case.BOX, dtype=torch.float64,
                          pending_capacity=case.PENDING, device="cpu")
    st, _ = mapping.map_insert(st, *(torch.from_numpy(a)
                                     for a in case.scans()[0]), cfg, mcfg, 1)
    f = lambda v: torch.tensor(v, dtype=torch.float64)
    kp = RBFParams(f(case.CAL[0]), f(case.CAL[1]))
    scan = tuple(torch.from_numpy(a) for a in case.moved_scans()[1])
    return st, scan, cfg, dict(depth_kp=kp, depth_s20=f(case.CAL[2]))


@pytest.mark.parametrize("eps", [0.25, 40.0], ids=["normal", "divergent"])
def test_samplers_on_card_match_cpu(dev, eps):
    """One NUTS transition (the same leapfrog counts), two HMC steps and
    five ADVI steps, card against CPU in float64, within 1e-9."""
    from gp_compressor_tpu_torch.testing import bayes_case

    res = bayes_case.device_parity(*bayes_case.bank(), bayes_case.THETA0,
                                   dev, eps=eps, max_depth=5,
                                   prior=bayes_case.PRIOR)
    assert res["nuts_leapfrogs_cpu"] == res["nuts_leapfrogs_device"]
    for k in ("nuts_theta", "nuts_accept", "hmc", "advi"):
        assert res[k] <= 1e-9, res


def test_smc_refine_pose_on_card_matches_cpu(dev, small_map):
    from gp_compressor_tpu_torch.testing import bayes_case

    st, scan, cfg, calib = small_map
    res = bayes_case.smc_parity(st, *scan, cfg, dev, num_particles=32,
                                n_eval_points=256, **calib)
    assert max(res.values()) <= 1e-9, res


def test_hmc_calibrated_compress_launches_the_kernel(dev):
    """compress_calibrated(method="hmc") on the card trains depth and RGB
    with the CUDA kernel: two launches."""
    import dataclasses

    from gp_compressor_tpu_torch import config as c
    from gp_compressor_tpu_torch.utils import synthetic
    from gp_compressor_tpu_torch.workloads import compressor

    cfg = c.CompressorConfig(
        patch=c.PatchConfig(res=0.3, sz=10, max_patches=256,
                            max_points_per_patch=64,
                            approx_sphere_moments=True,
                            bank_order="center_out"),
        depth_gp=c.GPConfig(capacity=14, slots=16, eps_tol=2.0),
        rgb_gp=dataclasses.replace(c.rgb_gp_config(slots=16, capacity=14),
                                   eps_tol=2.0))
    pts, cols = (torch.from_numpy(a).to(dev)
                 for a in synthetic.room_cloud(n=4000, seed=1))
    valid = torch.ones(4000, dtype=torch.bool, device=dev)
    n0 = launches()
    comp, kp, s20, cal = compressor.compress_calibrated(
        pts, cols, valid, cfg, method="hmc", calib_patches=8,
        calib_points=32, calib_steps=20)
    torch.cuda.synchronize()
    assert launches() == n0 + 2
    # the calibrated values leave the reference scale, and the RMSE bound
    # of the JAX package's calibrated test (tests/test_compressor.py)
    assert 0.0 < float(kp.sigmaf_sq) < 10.0 and 0.0 < s20 < 0.1
    rmse = float(compressor.reconstruction_rmse(comp, cal, depth_kp=kp,
                                                depth_s20=s20))
    assert rmse < 0.08


@pytest.fixture(scope="module")
def calib_bank(dev, bench):
    """The bench cloud's calibration bank at the benchmark's shapes (32
    patches x 64 points, float32) and its start theta [3]."""
    from gp_compressor_tpu_torch.workloads import compressor

    ccfg, batch, _ = bench
    return compressor._calib_logpost(batch, ccfg, 32, 64, torch.float32)


@pytest.fixture
def ascent_graphs():
    """The hmc module with an empty cache of ascent graphs."""
    from gp_compressor_tpu_torch.inference import hmc

    hmc._graphs.clear()
    yield hmc
    hmc._graphs.clear()


def _graph_counts():
    c = profiling.counters()
    return [c.get(f"calibration.{k}", 0)
            for k in ("eager_ascents", "graph_captures", "graph_replays")]


def _opaque(logpost):
    """The same posterior as an opaque callable, which always runs eager."""
    return lambda theta: logpost(theta)


def _same(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=0)


@pytest.mark.parametrize("starts,steps", [(1, 40), (4, 150)],
                         ids=["warm", "cold"])
def test_map_ascent_runs_eager_then_captures_then_replays(
        dev, calib_bank, ascent_graphs, starts, steps):
    """Three multi-start ascents of one shape: the first eager (one
    `calibration.step` span a step), the second captured and replayed,
    the third replayed, each equal to the eager ascent."""
    hmc = ascent_graphs
    lp, th0 = calib_bank
    kw = dict(steps=steps, lr=0.1, n_starts=starts)
    want = hmc.map_estimate_multi(_opaque(lp), th0, **kw)
    before = _graph_counts()
    profiling.take()
    profiling.tracing(True)
    try:
        runs = [hmc.map_estimate_multi(lp, th0, **kw) for _ in range(3)]
    finally:
        profiling.tracing(False)
    torch.cuda.synchronize()
    steps_seen = sum(r.name == "calibration.step" for r in profiling.take())
    assert [b - a for a, b in zip(before, _graph_counts())] == [1, 1, 2]
    assert steps_seen == steps
    for got in runs:
        _same(got, want)


def test_map_ascent_graph_replays_each_bank(dev, calib_bank, ascent_graphs):
    """Replays over two banks of one shape, from two starts: each gives the
    eager ascent of its own bank and start, and the first result is
    unchanged after the second replay."""
    hmc = ascent_graphs
    lp, th0 = calib_bank
    lp2 = lp.on_bank(lp.X.flip(0), 2.0 * lp.y.flip(0), lp.mask.flip(0))
    th2 = th0 + 0.5
    kw = dict(steps=40, lr=0.1)
    want = [hmc.map_estimate(_opaque(p), t, **kw)
            for p, t in ((lp, th0), (lp2, th2))]
    before = _graph_counts()
    hmc.map_estimate(lp, th0, **kw)
    first = hmc.map_estimate(lp, th0, **kw)
    kept = [t.clone() for t in first]
    second = hmc.map_estimate(lp2, th2, **kw)
    assert [b - a for a, b in zip(before, _graph_counts())] == [1, 1, 2]
    assert len(hmc._graphs) == 1
    _same(first, want[0])
    _same(second, want[1])
    assert all(torch.equal(a, b) for a, b in zip(first, kept))
    assert not torch.equal(first[0], second[0])


@pytest.mark.parametrize("case", ["gated", "nan_point"])
def test_map_ascent_graph_rejects_as_eager(dev, calib_bank, ascent_graphs,
                                           case):
    """Float64 bank, four starts. gated: the first start lies past the
    condition gate, so its log posterior is -inf at every step and, with
    a zero gradient, it never moves; the others ascend as eager. nan_point:
    a NaN point fails every factorization, so every start stays put at
    -inf."""
    import math

    hmc = ascent_graphs
    lp, th0 = calib_bank
    X, y, m = (t.double() for t in (lp.X, lp.y, lp.mask))
    if case == "nan_point":
        X[3, 0, 0] = math.nan
    lp64 = hmc.make_patch_logpost(X, y, m)
    th0 = th0.double()
    past = torch.tensor([math.log(1e6), 0.0, math.log(1e-10)],
                        dtype=torch.float64, device=dev)
    starts = torch.stack([past, th0, th0 - 3.0, th0 + 1.0])
    kw = dict(steps=40, lr=0.1)
    want = hmc.map_estimate(_opaque(lp64), starts, **kw)
    before = _graph_counts()
    runs = [hmc.map_estimate(lp64, starts, **kw) for _ in range(3)]
    assert [b - a for a, b in zip(before, _graph_counts())] == [1, 1, 2]
    stuck = slice(None) if case == "nan_point" else slice(0, 1)
    for theta, trace in runs:
        _same((theta, trace), want)
        assert torch.equal(theta[stuck], starts[stuck])
        assert (trace[:, stuck] == -torch.inf).all()
        if case == "gated":
            assert torch.isfinite(trace[-1, 1:]).all()


@pytest.fixture
def omp_graphs():
    """The dictionary module with an empty cache of OMP graphs."""
    from gp_compressor_tpu_torch.models import dictionary

    dictionary._graphs.clear()
    yield dictionary
    dictionary._graphs.clear()


def _omp_counts():
    return [count(f"ksvd.{k}")
            for k in ("omp_eager", "omp_graph_captures", "omp_graph_replays")]


# the benchmark's depth and colour encodings (l 400)
OMP_SHAPES = {"depth": dict(n=2048, K=200, words=10),
              "colour": dict(n=6144, K=600, words=20)}


def _omp_problem(dev, n, K, words, seed=0):
    """(D, S, W, valid, cfg), float32 on the card: ksvd_case's sparse rows
    with masks and padding, a dictionary of normalised data rows (as
    K-SVD's first one). Every atom is 0 on coordinates 0 and 1 but atom
    0, which is the first axis; row 0 is the first two axes, unmasked. Its
    second word finds every unused correlation exactly 0 and takes atom
    0 again: a singular unit-diagonal Gram."""
    import numpy as np

    from gp_compressor_tpu_torch.config import KSVDConfig
    from gp_compressor_tpu_torch.testing import ksvd_case

    S, W, valid = ksvd_case.problem(l=400, K=K, n=n, words=3, seed=seed)
    r = np.random.default_rng(seed)
    D = S[r.choice(n - 10, size=K, replace=False)].T.copy()
    D[:2] = 0.0
    D /= np.linalg.norm(D, axis=0)
    D[:, 0] = 0.0
    D[0, 0] = 1.0
    S[0], W[0] = 0.0, 1.0
    S[0, :2] = 1.0
    cfg = KSVDConfig(dict_size=K, words_max=words, proj_error=0.3)
    D, S, W = (torch.from_numpy(a).to(dev, torch.float32) for a in (D, S, W))
    return D, S, W, torch.from_numpy(valid).to(dev), cfg


def _same_bits(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(_bits(g.reshape(-1)), _bits(w.reshape(-1)))


@pytest.mark.parametrize("shape", list(OMP_SHAPES))
def test_omp_runs_eager_then_captures_then_replays(dev, omp_graphs, shape):
    """Three encodings of one problem: the first eager, the second
    captured and replayed, the third replayed; X, I and nw of each equal
    the eager body's bit for bit, row 0's non-finite coefficients of a
    singular Gram included."""
    dictionary = omp_graphs
    D, S, W, valid, cfg = _omp_problem(dev, **OMP_SHAPES[shape])
    want = dictionary._omp_encode_eager(D, S, W, valid, cfg)
    before = _omp_counts()
    runs = [dictionary.omp_encode(D, S, W, valid, cfg) for _ in range(3)]
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(before, _omp_counts())] == [1, 1, 2]
    assert want.I[0, 1] == 0 and want.nw[0] == 2
    assert not torch.isfinite(want.X[0]).all()
    assert 2 < float(want.nw[valid].float().mean()) < cfg.words_max
    for got in runs:
        _same_bits(got, want)


def test_omp_graph_replays_each_problem(dev, omp_graphs):
    """Two problems of the depth shapes through one graph: each gets the
    eager body's code of its own data, and the first code is unchanged
    after the second replay."""
    dictionary = omp_graphs
    one = _omp_problem(dev, **OMP_SHAPES["depth"])
    two = _omp_problem(dev, **OMP_SHAPES["depth"], seed=1)
    want = [dictionary._omp_encode_eager(*p) for p in (one, two)]
    before = _omp_counts()
    dictionary.omp_encode(*one)
    first = dictionary.omp_encode(*one)
    kept = [t.clone() for t in first]
    second = dictionary.omp_encode(*two)
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(before, _omp_counts())] == [1, 1, 2]
    assert len(dictionary._graphs) == 1
    _same_bits(first, want[0])
    _same_bits(second, want[1])
    _same_bits(first, kept)
    assert not torch.equal(first.I, second.I)


@pytest.mark.parametrize("shape", list(OMP_SHAPES))
def test_omp_replay_makes_no_synchronising_call(dev, omp_graphs, shape):
    """A replayed encoding makes no synchronising call; an eager one makes
    none per word: as many at half the words as at all of them."""
    import dataclasses

    dictionary = omp_graphs
    D, S, W, valid, cfg = _omp_problem(dev, **OMP_SHAPES[shape])
    half = dataclasses.replace(cfg, words_max=cfg.words_max // 2)
    dictionary._omp_encode_eager(D, S, W, valid, cfg)      # warm-up
    _, eager = count_syncs(lambda: dictionary.omp_encode(D, S, W, valid, cfg))
    _, eager_half = count_syncs(
        lambda: dictionary.omp_encode(D, S, W, valid, half))
    dictionary.omp_encode(D, S, W, valid, cfg)             # the capture
    _, replay = count_syncs(lambda: dictionary.omp_encode(D, S, W, valid,
                                                           cfg))
    assert _omp_counts()[0] >= 2
    assert replay == 0
    assert eager == eager_half


def test_ksvd_replays_every_omp_call_after_the_first(dev, omp_graphs):
    """K-SVD on a compress's depth and colour problems with fixed draws,
    from an empty cache: the first encoding of each eager, the second
    captured, every later one replayed; a second run of each replays
    every encoding (one a sweep and a final one) and gives the first
    run's dictionary, codes and error bit for bit (the first run's first
    code was eager's). A compress after them replays every encoding."""
    from gp_compressor_tpu_torch.models import dictionary
    from gp_compressor_tpu_torch.workloads import ksvd_compressor as kc

    pts, cols, valid, cfg = _ksvd_cloud(dev)
    raster = kc.compress(pts, cols, valid, cfg).raster
    omp_graphs._graphs.clear()
    pvalid = torch.arange(raster.S.shape[0], device=dev) < raster.n_leaves
    problems = ((raster.S, raster.W.to(raster.S.dtype), pvalid, cfg.ksvd),
                kc.rgb_problem(raster, pvalid) + (cfg.rgb_ksvd,))
    g = torch.Generator(device=dev).manual_seed(3)
    for S, W, v, kcfg in problems:
        draws = dictionary.draw_ksvd(v, kcfg, g)
        before = _omp_counts()
        first = dictionary.ksvd(S, W, v, kcfg, draws=draws)
        assert [b - a for a, b in zip(before, _omp_counts())] == \
            [1, 1, first.iters]
        before = _omp_counts()
        again = dictionary.ksvd(S, W, v, kcfg, draws=draws)
        assert [b - a for a, b in zip(before, _omp_counts())] == \
            [0, 0, again.iters + 1]
        assert again.iters == first.iters
        _same_bits((again.D, again.error) + tuple(again.code),
                   (first.D, first.error) + tuple(first.code))
    assert len(omp_graphs._graphs) == 2
    before = _omp_counts()
    comp = kc.compress(pts, cols, valid, cfg)
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(before, _omp_counts())] == \
        [0, 0, comp.depth.iters + comp.rgb.iters + 2]
    assert kc.rms_error(comp) < 0.08


@pytest.mark.parametrize("block", [1, 16])
def test_ksvd_sweep_on_card_matches_cpu(dev, block):
    """omp_encode and one outer sweep (the atom sweep in Gauss-Seidel order
    and in blocks of 16 over 40 atoms: a short last block), card against
    CPU in float64 with the same draws."""
    from gp_compressor_tpu_torch.config import KSVDConfig
    from gp_compressor_tpu_torch.testing import ksvd_case

    cfg = KSVDConfig(dict_size=40, words_max=3, proj_error=1e-8,
                     atom_block=block)
    k0, b0 = count("ksvd.block_kernels"), count("ksvd.atom_blocks")
    res = ksvd_case.sweep_parity(*ksvd_case.problem(), cfg, dev)
    assert res["indices_equal"], res
    for k in ("omp_X", "sweep_D", "sweep_X", "sweep_err"):
        assert res[k] <= 1e-9, res
    # one launch per block on the card, none on the CPU
    blocks = -(-40 // block)
    assert count("ksvd.block_kernels") - k0 == blocks
    assert count("ksvd.atom_blocks") - b0 == 2 * blocks


BLOCKS = {"depth": dict(n=2048, l=400, b=16, n_valid=1800),
          "colour": dict(n=6144, l=400, b=8, n_valid=5400, share=0.03),
          "nan_row": dict(n=2048, l=400, b=16, n_valid=1800)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(BLOCKS))
def test_block_kernel_matches_dense(dev, case, dtype):
    """The block kernel against the dense plain version on one block of
    the depth shapes (n 2,048, l 400, 16 atoms) and of the colour shapes
    (n 6,144, a short last block of 8): an atom with no user, one with one
    user, one whose users are every valid row (more than a CTA's shared
    memory stages: the rest re-formed from R and W), padding rows; and
    (nan_row) a NaN in a padding row of R, which the dense stack spreads
    to every atom with users through 0 x NaN."""
    from gp_compressor_tpu_torch.cuda_kernels import ksvd_power
    from gp_compressor_tpu_torch.models import dictionary
    from gp_compressor_tpu_torch.testing import ksvd_case

    R, W, D, xj, using = (torch.from_numpy(a).to(dev) for a in
                          ksvd_case.block_problem(**BLOCKS[case]))
    R, W, D, xj = (t.to(dtype) for t in (R, W, D, xj))
    if case == "nan_row":
        R[-1, 5] = float("nan")
    b, n, l = xj.shape[0], R.shape[0], R.shape[1]
    geo = ksvd_power.power_geometry(n, l, R.element_size())
    assert int(using[2].sum()) > ksvd_power.CLUSTER * geo.rows_cap
    dj = D[:, 2:b + 2].T
    k0 = count("ksvd.block_kernels")
    got = dictionary._block_update(R, W, dj, xj, using, 20)
    assert count("ksvd.block_kernels") - k0 == 1
    want = dictionary._block_update_plain(R, W, dj, xj, using, 20)
    torch.cuda.synchronize()
    same_block(got, want, dtype)
    u, x = got
    assert torch.equal(u[0], dj[0]) and torch.equal(x[0], xj[0])
    if case == "nan_row":
        assert torch.isnan(u[1:]).all() and torch.isnan(x[1:]).all()
    else:
        assert torch.isfinite(u).all() and torch.isfinite(x).all()
        assert torch.equal(x[1:] != 0, using[1:])


def test_block_kernel_singular_gram_matches_dense(dev, monkeypatch):
    """test_omp_singular_gram_matches_jax's case on the card in float64:
    OMP leaves non-finite coefficients, and every block of the atom sweep
    (blocks of 4 over 6 atoms) gives the kernel's u and x_new the dense
    code's non-finite entries and, elsewhere, its values."""
    import numpy as np

    from gp_compressor_tpu_torch.config import KSVDConfig
    from gp_compressor_tpu_torch.models import dictionary

    l, K, n = 12, 6, 5
    r = np.random.default_rng(2)
    S = r.standard_normal((n, l))
    S[3, K:] = 0.0
    W = np.ones((n, l))
    W[1, 2] = 0.0
    D, S, W = (torch.from_numpy(a).to(dev)
               for a in (np.eye(l)[:, :K], S, W))
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    cfg = KSVDConfig(dict_size=K, words_max=K + 2, proj_error=1e-12,
                     atom_block=4)
    code = dictionary.omp_encode(D, S, W, valid, cfg)
    assert not torch.isfinite(code.X).all()
    seen = []
    real = dictionary._block_update

    def both(*a):
        got = real(*a)
        seen.append((got, dictionary._block_update_plain(*a)))
        return got

    monkeypatch.setattr(dictionary, "_block_update", both)
    k0 = count("ksvd.block_kernels")
    dictionary._atom_sweep(D, code, S, W, valid, cfg)
    torch.cuda.synchronize()
    assert len(seen) == 2 and count("ksvd.block_kernels") - k0 == 2
    assert any(not torch.isfinite(g[0]).all() for g, _ in seen)
    for got, want in seen:
        same_block(got, want, torch.float64)


def test_block_kernel_matches_dense_in_a_compress(dev, monkeypatch):
    """Every block of a small K-SVD compress on the card (float32, the
    real users of real sweeps) against the dense plain version on the
    same inputs."""
    from gp_compressor_tpu_torch.models import dictionary
    from gp_compressor_tpu_torch.workloads import ksvd_compressor

    gaps = []
    real = dictionary._block_update

    def both(*a):
        got = real(*a)
        gaps.append(same_block(got, dictionary._block_update_plain(*a),
                                torch.float32))
        return got

    monkeypatch.setattr(dictionary, "_block_update", both)
    pts, cols, valid, cfg = _ksvd_cloud(dev)
    k0, b0 = count("ksvd.block_kernels"), count("ksvd.atom_blocks")
    ksvd_compressor.compress(pts, cols, valid, cfg)
    assert len(gaps) == count("ksvd.block_kernels") - k0 \
        == count("ksvd.atom_blocks") - b0 > 0


def test_block_kernel_runs_a_block_of_16_atoms_at_once(dev):
    """At the depth and colour shapes the card holds at least 16 clusters
    of the kernel at once (two CTAs an SM, ksvd_power.SMEM_MAX), so a
    block of atom_block 16 runs in one wave."""
    from gp_compressor_tpu_torch.cuda_kernels import ksvd_power

    for n in (2048, 6144):
        for dt in (torch.float32, torch.float64):
            assert ksvd_power.max_active_clusters(n, 400, dt) >= 16


def test_block_wrapper_rejects_what_the_kernel_does_not_take(dev):
    from gp_compressor_tpu_torch.cuda_kernels import ksvd_power

    R = torch.zeros((64, 8), device=dev)
    dj, xj = torch.zeros((4, 8), device=dev), torch.zeros((4, 64), device=dev)
    using = torch.zeros((4, 64), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="one CUDA device"):
        ksvd_power.block_power(R, R.cpu(), dj, xj, using, 20)
    with pytest.raises(TypeError, match="dtype"):
        ksvd_power.block_power(R, R.double(), dj, xj, using, 20)
    with pytest.raises(ValueError, match="contiguous"):
        ksvd_power.block_power(R, R, dj, xj.T.contiguous().T, using, 20)
    u, x = ksvd_power.block_power(R, R, dj, xj, using, 0)
    torch.cuda.synchronize()
    assert torch.equal(u, dj) and torch.equal(x, xj)


def _ksvd_cloud(dev):
    from gp_compressor_tpu_torch import config as c
    from gp_compressor_tpu_torch.utils import synthetic

    cfg = c.CompressorConfig(
        patch=c.PatchConfig(res=0.3, sz=10, max_patches=512,
                            max_points_per_patch=256),
        ksvd=c.KSVDConfig(dict_size=40, words_max=6, proj_error=1e-4,
                          stop_diff=1e-4, max_iters=8, atom_block=16),
        rgb_ksvd=c.KSVDConfig(dict_size=60, words_max=8, proj_error=1e-1,
                              stop_diff=1e-1, max_iters=8, atom_block=16))
    pts, cols = (torch.from_numpy(a).to(dev)
                 for a in synthetic.room_cloud(n=6000, seed=5))
    return pts, cols, torch.ones(6000, dtype=torch.bool, device=dev), cfg


def test_ksvd_compress_reads_once_per_sweep(dev):
    """ksvd_compressor.compress on the card reads the device once per sweep
    of each ksvd call (at most iters + 1 per call), launches no training
    kernel, and decompresses to finite points."""
    from gp_compressor_tpu_torch.workloads import ksvd_compressor

    pts, cols, valid, cfg = _ksvd_cloud(dev)
    n0 = launches()
    r0 = profiling.counters().get("ksvd.reads", 0)
    comp = ksvd_compressor.compress(pts, cols, valid, cfg)
    torch.cuda.synchronize()
    assert profiling.counters()["ksvd.reads"] - r0 \
        == comp.depth.iters + comp.rgb.iters
    assert 1 <= comp.depth.iters <= 8 and 1 <= comp.rgb.iters <= 8
    assert launches() == n0
    assert ksvd_compressor.rms_error(comp) < 0.08
    w, c, ok = ksvd_compressor.decompress(comp)
    assert torch.isfinite(w[ok]).all() and torch.isfinite(c).all()


def test_icp_register_on_card_matches_cpu(dev):
    """icp_register on a small map (compressed on the CPU in float64, then
    moved to the card): the same iterations, R and t within 1e-9."""
    from gp_compressor_tpu_torch import config as c
    from gp_compressor_tpu_torch.testing import bayes_case
    from gp_compressor_tpu_torch.utils import synthetic
    from gp_compressor_tpu_torch.workloads import compressor, icp

    cfg = c.CompressorConfig(
        patch=c.PatchConfig(res=0.3, sz=10, max_patches=512,
                            max_points_per_patch=64),
        depth_gp=c.GPConfig(capacity=14, slots=16, dtype=torch.float64),
        rgb_gp=c.rgb_gp_config(slots=16, capacity=14, dtype=torch.float64))
    pts, cols = synthetic.room_cloud(n=9000, seed=4)
    pts = pts.astype("float64")
    comp = compressor.compress(torch.from_numpy(pts[:4500]),
                               torch.from_numpy(cols[:4500]).double(),
                               torch.ones(4500, dtype=torch.bool), cfg)
    scan, _ = synthetic.rigid_transform(pts[4500:], [0.0, 0.008, -0.006],
                                        [0.02, -0.015, 0.01])
    scan = torch.from_numpy(scan)
    valid = torch.ones(4500, dtype=torch.bool)
    ref = icp.icp_register(comp, scan, valid, cfg)
    out = icp.icp_register(bayes_case.to_device(comp, dev), scan.to(dev),
                           valid.to(dev), cfg)
    assert out.iters == ref.iters > 1
    assert int(out.n_matched) == int(ref.n_matched)
    for a, b in ((out.R, ref.R), (out.t, ref.t)):
        assert float(torch.max(torch.abs(a.cpu() - b))) <= 1e-9


def test_native_library_builds_on_the_card_machine(dev, tmp_path):
    """The port's native IO library compiles there from native/gpio.cpp
    into build/torch_native/ and writes JAX's PCD bytes (the NumPy
    writer's) for a binary cloud."""
    import numpy as np

    from gp_compressor_tpu_torch.io import native, pcd

    assert native.available()
    assert native.build()._name.startswith(str(native.BUILD_DIR))
    r = np.random.default_rng(0)
    pts = r.uniform(-3, 3, size=(500, 3)).astype(np.float32)
    cols = r.integers(0, 256, size=(500, 3)).astype(np.float32)
    a, b = str(tmp_path / "a.pcd"), str(tmp_path / "b.pcd")
    native.write_pcd(a, pts, cols)
    pcd.write(b, pts, cols)
    assert open(a, "rb").read() == open(b, "rb").read()
    got = native.read_pcd(a)
    assert np.array_equal(got[0], pts) and np.array_equal(got[1], cols)


def test_cli_runs_on_the_card_by_default(dev, tmp_path, capsys):
    """gp-compress with no --device runs on the card: two kernel
    launches, and its checkpoint loads strictly into a template on the
    card, leaves on the card."""
    import argparse

    from gp_compressor_tpu_torch import cli
    from gp_compressor_tpu_torch.io import checkpoint
    from gp_compressor_tpu_torch.utils import synthetic
    from gp_compressor_tpu_torch.workloads import compressor

    argv = ["--n-points", "20000", "--res", "0.3", "--sz", "10",
            "--max-patches", "512", "--max-ppp", "64"]
    ckpt = str(tmp_path / "c.npz")
    n0 = launches()
    cli.main(["gp-compress", *argv, "--checkpoint", ckpt])
    assert launches() == n0 + 2
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "Size of original point cloud: 20000"
    cfg = cli._gp_config(argparse.Namespace(
        res=0.3, sz=10, max_patches=512, max_ppp=64, capacity=100,
        eps_tol=1e-6, dict_size=200, words_max=10, rgb_dict_size=600,
        rgb_words_max=20))
    pts, cols = (torch.from_numpy(a).to(dev)
                 for a in synthetic.room_cloud(n=20000, seed=0))
    like = compressor.compress(pts, cols, torch.ones(20000, dtype=torch.bool,
                                                     device=dev), cfg)
    got = checkpoint.load(ckpt, like, strict=True)
    assert got.depth_gp.C.is_cuda and got.patch.X.is_cuda
    assert int(got.patch.n_leaves) == int(like.patch.n_leaves)
