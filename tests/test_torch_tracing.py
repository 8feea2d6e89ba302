"""The port's tracing (utils/profiling.py) on the CPU: the span tree of
each request of the round trips, one `calibration.step` per Adam step,
the mapping stream's stage spans, the K-SVD codec's spans and sweep
counts, outputs bit-identical with tracing on and off, nothing recorded
with tracing off (and nothing allocated by a span then), and counts
attached to the innermost open span."""

import dataclasses
import math
import tracemalloc

import pytest
import torch

from gp_compressor_tpu_torch import config as tcfg
from gp_compressor_tpu_torch.inference import nuts
from gp_compressor_tpu_torch.testing import mapping_case as case
from gp_compressor_tpu_torch.utils import profiling, synthetic
from gp_compressor_tpu_torch.workloads import compressor, ksvd_compressor
from gp_compressor_tpu_torch.workloads import mapping

N = 3000
STEPS = 5
FRONT_END = ["front_end.grid", "front_end.moments", "front_end.frames",
             "front_end.claims", "front_end.banks"]


def _cfg():
    return tcfg.CompressorConfig(
        patch=tcfg.PatchConfig(res=0.3, sz=10, max_patches=256,
                               max_points_per_patch=64,
                               approx_sphere_moments=True,
                               bank_order="center_out"),
        depth_gp=tcfg.GPConfig(capacity=14, slots=16, eps_tol=2.0),
        rgb_gp=dataclasses.replace(tcfg.rgb_gp_config(slots=16, capacity=14),
                                   eps_tol=2.0))


def _args(seed=1):
    pts, cols = synthetic.room_cloud(n=N, seed=seed)
    return (torch.from_numpy(pts), torch.from_numpy(cols),
            torch.ones(N, dtype=torch.bool), _cfg())


def _round_trip(*a):
    return compressor.compress_decompress(*a)


def _calibrated(*a):
    return compressor.compress_decompress_calibrated(
        *a, calib_patches=8, calib_points=16, calib_steps=STEPS,
        calib_starts=2)


@pytest.fixture
def traced():
    """Tracing on for the test, with an empty store; off afterwards."""
    profiling.take()
    profiling.tracing(True)
    try:
        yield
    finally:
        profiling.tracing(False)
        profiling.take()


def _tree(recs):
    """{request: [(name, parent's name), ...] in opening order}."""
    by_id = {r.id: r for r in recs}
    out = {}
    for r in sorted(recs, key=lambda r: r.id):
        parent = by_id[r.parent].name if r.parent is not None else None
        out.setdefault(r.request, []).append((r.name, parent))
    return out


def _want(calibrated: bool):
    tree = [("round_trip", None), ("front_end", "round_trip")]
    tree += [(s, "front_end") for s in FRONT_END]
    if calibrated:
        tree += [("calibration", "round_trip")]
        tree += [("calibration.step", "calibration")] * STEPS
    return tree + [("train.depth", "round_trip"), ("train.rgb", "round_trip"),
                   ("sanitize", "round_trip"), ("decompress", "round_trip")]


@pytest.mark.parametrize("run,calibrated", [(_round_trip, False),
                                            (_calibrated, True)],
                         ids=["round_trip", "calibrated"])
def test_span_tree_per_request(traced, run, calibrated):
    """Two requests: each the table's tree, in order, under its own
    request id; a child lies inside its parent on the host's clock."""
    run(*_args(1))
    run(*_args(2))
    recs = profiling.take()
    tree = _tree(recs)
    assert len(tree) == 2
    r0, r1 = sorted(tree)
    assert r1 == r0 + 1
    assert tree[r0] == tree[r1] == _want(calibrated)
    by_id = {r.id: r for r in recs}
    for r in recs:
        assert r.start <= r.end
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start <= r.start and r.end <= p.end
            assert p.request == r.request
        else:
            assert r.name == "round_trip"
    # siblings run one after another
    for req in (r0, r1):
        top = sorted((r for r in recs if r.request == req
                      and r.parent is not None
                      and by_id[r.parent].parent is None),
                     key=lambda r: r.id)
        assert all(a.end <= b.start for a, b in zip(top, top[1:]))


@pytest.mark.parametrize("run", [_round_trip, _calibrated],
                         ids=["round_trip", "calibrated"])
def test_outputs_bit_identical_with_tracing_on_and_off(run):
    args = _args(3)
    off = run(*args)
    profiling.tracing(True)
    try:
        on = run(*args)
    finally:
        profiling.tracing(False)
    assert profiling.take()
    a = [t for t in _leaves(off)]
    b = [t for t in _leaves(on)]
    assert len(a) == len(b) > 10
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and torch.equal(u, v)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def test_tracing_off_records_nothing_and_allocates_nothing():
    profiling.take()
    _round_trip(*_args(4))
    assert profiling.take() == []
    assert profiling.span("front_end") is profiling.span("front_end")

    @profiling.span("decorated")
    def f(x):
        return x

    with profiling.span("warm"):
        f(0)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for i in range(10_000):
            with profiling.span("front_end"):
                f(i)
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown < 1024
    assert profiling.take() == []


def test_counts_attach_to_the_innermost_span(traced):
    """Totals count everywhere; a span's counts hold what was counted
    while it was the innermost open span (NUTS's counts inside a nested
    span land there, not on its parent)."""
    profiling.reset_counters()
    logpost = lambda th: -0.5 * torch.sum(th * th, dim=-1)
    theta = torch.zeros((2, 3), dtype=torch.float64)
    g = torch.Generator().manual_seed(0)
    with profiling.span("sampler"):
        profiling.count("outer.items", 4)
        with profiling.span("sampler.step"):
            nuts.nuts_step(logpost, theta, torch.full((2,), 0.5,
                                                      dtype=torch.float64),
                           torch.ones_like(theta), max_depth=3, generator=g)
    profiling.count("outer.items")                  # no span open
    recs = {r.name: r for r in profiling.take()}
    assert recs["sampler"].counts == {"outer.items": 4}
    step = recs["sampler.step"].counts
    assert step["nuts.transitions"] == 2
    c = profiling.counters()
    assert c["outer.items"] == 5
    for k in ("nuts.transitions", "nuts.iterations", "nuts.reads"):
        assert step[k] == c[k]
    assert int(step["nuts.leapfrogs"]) == int(c["nuts.leapfrogs"]) >= 2


def test_mapping_stages_are_spans(traced):
    """add_cloud_fused: `map.register`, then map_insert's stages in order
    (a float64 map of the small case's first two scans, on the CPU)."""
    cfg = case.compressor_config(tcfg, torch.float64)
    mcfg = case.mapping_config(tcfg)
    rcfg = case.registration_config(tcfg)
    st = mapping.map_init(cfg, mcfg, *case.BOX, dtype=torch.float64,
                          pending_capacity=case.PENDING, device="cpu")
    for p, c, v in case.scans()[:2]:
        st, _, _, _ = mapping.add_cloud_fused(
            st, torch.from_numpy(p), torch.from_numpy(c),
            torch.from_numpy(v), cfg, mcfg, rcfg=rcfg)
    names = [r.name for r in sorted(profiling.take(), key=lambda r: r.id)
             if r.name.startswith("map.")]
    stages = ["map.register", "map.allocate", "map.sphere_stats",
              "map.tables", "map.claims", "map.sort_banks", "map.train",
              "map.sanitize", "map.pending", "map.carve"]
    assert names == stages * 2
    assert int(st.n_patches) > 0
    assert math.isfinite(float(st.means[:int(st.n_patches)].sum()))


def _ksvd_round_trip(seed=5):
    """A tiny K-SVD compress and decompress: (compressed, decompressed)."""
    cfg = dataclasses.replace(
        _cfg(), ksvd=tcfg.KSVDConfig(dict_size=16, words_max=4, max_iters=4,
                                     atom_block=4),
        rgb_ksvd=dataclasses.replace(tcfg.rgb_ksvd_config(24, 6),
                                     max_iters=3, atom_block=8))
    pts, cols, valid, _ = _args(seed)
    comp = ksvd_compressor.compress(pts, cols, valid, cfg,
                                    generator=torch.Generator().manual_seed(0))
    return comp, ksvd_compressor.decompress(comp)


def test_ksvd_spans_and_sweep_counts(traced):
    """compress: the raster's front end, then one span per K-SVD, each
    holding (omp, sweep, replace) per sweep and the final encoding;
    decompress its own request. `ksvd.sweeps` on each K-SVD's span equals
    its sweeps, `ksvd.atom_blocks` on each sweep span its blocks."""
    comp, _ = _ksvd_round_trip()
    recs = profiling.take()
    tree = _tree(recs)
    assert len(tree) == 2
    r0, r1 = sorted(tree)
    sweep = [("ksvd.omp", None), ("ksvd.sweep", None), ("ksvd.replace", None)]

    def ksvd_span(name, iters):
        return [(name, "ksvd.compress")] + [
            (s, name) for s, _ in sweep * iters + [("ksvd.omp", None)]]

    want = ([("ksvd.compress", None), ("ksvd.front_end", "ksvd.compress")]
            + [(s, "ksvd.front_end") for s in FRONT_END[:4]]
            + ksvd_span("ksvd.depth", comp.depth.iters)
            + ksvd_span("ksvd.rgb", comp.rgb.iters))
    assert tree[r0] == want
    assert tree[r1] == [("ksvd.decompress", None)]
    by_name = {}
    for r in recs:
        by_name.setdefault(r.name, []).append(r)
    for name, res in (("ksvd.depth", comp.depth), ("ksvd.rgb", comp.rgb)):
        (rec,) = by_name[name]
        assert rec.counts["ksvd.sweeps"] == res.iters >= 1
        assert rec.counts["ksvd.reads"] == res.iters
    blocks = sorted(r.counts["ksvd.atom_blocks"]
                    for r in by_name["ksvd.sweep"])
    assert blocks == sorted([4] * comp.depth.iters + [3] * comp.rgb.iters)


def test_ksvd_outputs_bit_identical_with_tracing_on_and_off():
    off = _ksvd_round_trip(6)
    profiling.tracing(True)
    try:
        on = _ksvd_round_trip(6)
    finally:
        profiling.tracing(False)
    assert profiling.take()
    a, b = list(_leaves(off)), list(_leaves(on))
    assert len(a) == len(b) > 10
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and torch.equal(u, v)
