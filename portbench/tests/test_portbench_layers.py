"""The layer split of a profiled trace (harness/layers.py) on fabricated
profiler events: idle to the innermost span open when a gap began,
kernels to the span open at their launching call (found by correlation
id, on any thread), syncs inside `round_trip`, the closure of both
splits, and nothing where the program left no span."""

from types import SimpleNamespace

import pytest
import torch

from portbench.harness import layers

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, t0, t1, dev=CPU, corr=0, thread=1):
    return SimpleNamespace(name=name, device_type=dev, id=corr, thread=thread,
                           time_range=SimpleNamespace(start=t0, end=t1))


def launch(corr, t, thread=1):
    return ev("cudaLaunchKernel", t, t + 2, corr=corr, thread=thread)


def kernel(corr, t0, t1, name="void some_kernel<float>()"):
    return ev(name, t0, t1, dev=CUDA, corr=corr)


SPANS = {"round_trip", "front_end", "front_end.claims", "calibration",
         "calibration.step", "train.depth", "decompress"}


def _trace():
    """One request [0, 1000] us: round_trip [10, 990] holds front_end
    [20, 300] (its claims [100, 300]), calibration [300, 600] (one step
    [300, 600]), train.depth [600, 800] and decompress [800, 950]."""
    return [
        ev(layers.REQUEST + "0", 0, 1000),
        ev(layers.REQUEST + "0", 0, 1000, dev=CUDA),   # the mirrored range
        ev("round_trip", 10, 990), ev("front_end", 20, 300),
        ev("front_end.claims", 100, 300), ev("calibration", 300, 600),
        ev("calibration.step", 300, 600), ev("train.depth", 600, 800),
        ev("decompress", 800, 950),
        ev("aten::mul", 110, 120),
        # a copy before the round trip (the harness's), launched outside
        ev("cudaMemcpyAsync", 2, 4, corr=1),
        ev("Memcpy HtoD (Pageable -> Device)", 4, 8, dev=CUDA, corr=1),
        # front_end: launched at 50 and 150 (in claims)
        launch(2, 50), kernel(2, 52, 90),
        launch(3, 150), kernel(3, 160, 200),
        # the calibration step's backward launches from autograd's own
        # thread; the device runs behind and ends after the span
        launch(4, 400, thread=7), kernel(4, 590, 650),
        # training's kernel, launched at 610, runs 650-760
        launch(5, 610), kernel(5, 650, 760),
        # a kernel whose runtime call the trace lost
        kernel(6, 900, 920),
        # a synchronising call inside the round trip, one outside
        ev("cudaStreamSynchronize", 940, 945, corr=7),
        ev("cudaDeviceSynchronize", 992, 999, corr=8),
    ]


def test_idle_goes_to_the_innermost_span_open_at_the_gap():
    """busy: [4, 8], [52, 90], [160, 200], [590, 760], [900, 920]; each
    gap by the spans open at its start: [0, 4] and [8, 52] before the
    round trip opens at 10, [90, 160] in front_end, [200, 590] in its
    claims, [760, 900] in train.depth, [920, 1000] in decompress."""
    res = layers.attribute(layers.keep(_trace(), SPANS))
    want = {"outside": 48, "front_end": 70 + 390, "train": 140,
            "decompress": 80}
    assert res["idle_s"] == pytest.approx({k: v / 1e6
                                           for k, v in want.items()})
    by_span = {"(no span)": 48, "front_end": 70, "front_end.claims": 390,
               "train.depth": 140, "decompress": 80}
    assert res["idle_by_span"] == pytest.approx(
        {k: v / 1e6 for k, v in by_span.items()})


def test_closure_is_exact():
    kept = layers.keep(_trace(), SPANS)
    res = layers.attribute(kept)
    busy = 4 + 38 + 40 + 170 + 20
    assert sum(res["idle_s"].values()) == pytest.approx((1000 - busy) / 1e6,
                                                        abs=1e-15)
    assert sum(res["idle_by_span"].values()) == pytest.approx(
        sum(res["idle_s"].values()), abs=1e-15)
    assert sum(res["launches"].values()) == res["kernels"] == 5
    # the profiled window on the host's clock holds the requests' ranges;
    # the rest of it is idle outside round_trip, so the split sums to the
    # window's idle
    res = layers.attribute(kept, window_s=1.2e-3)
    assert res["range_s"] == pytest.approx(1e-3)
    assert res["busy_in_s"] == pytest.approx(busy / 1e6)
    assert res["busy_out_s"] == 0.0
    assert sum(res["idle_s"].values()) == pytest.approx(1.2e-3 - busy / 1e6,
                                                        abs=1e-15)
    assert res["idle_s"]["outside"] == pytest.approx((48 + 200) / 1e6)


def test_launches_follow_the_launching_call_on_any_thread():
    res = layers.attribute(layers.keep(_trace(), SPANS))
    # copies are no kernels; kernel 4 ran after its span but was launched
    # inside calibration.step from thread 7; kernel 6 has no runtime call
    assert res["launches"] == {"front_end": 2, "calib": 1, "train": 1,
                               "outside": 1}
    assert res["unmatched"] == 1
    assert res["syncs"] == 1
    assert res["named_as_span"] == 0
    pc = layers.per_cloud(res)
    assert pc["calib_launches"] == 1 and pc["front_end_launches"] == 2
    assert pc["syncs_per_cloud"] == 1
    assert pc["decompress_launches"] == 0
    assert pc["decompress_idle_ms"] == pytest.approx(80 / 1e3)


def test_a_span_mirrored_onto_the_device_is_counted():
    events = _trace() + [ev("front_end", 20, 300, dev=CUDA)]
    assert layers.attribute(layers.keep(events, SPANS))["named_as_span"] == 1


def test_no_metric_without_the_programs_spans():
    """The parent's program, or tracing off: no span in the trace, so no
    layer reads anything (all idle and kernels fall outside), and a trace
    without requests gives no metric at all."""
    events = [e for e in _trace() if e.name not in SPANS]
    res = layers.attribute(layers.keep(events, set()))
    pc = layers.per_cloud(res)
    for layer in ("front_end", "train", "decompress", "calib"):
        assert pc.get(f"{layer}_idle_ms") is None
        assert pc.get(f"{layer}_launches") is None
    assert pc.get("syncs_per_cloud") is None
    assert set(res["idle_s"]) == {"outside"}
    assert res["syncs"] == 0
    assert layers.per_cloud(layers.attribute(layers.keep([], set()))) == {}


def test_setup_program_s_sums_the_outermost_spans():
    rec = lambda parent, s, e: SimpleNamespace(parent=parent, start=s, end=e)
    recs = [rec(None, 0.0, 2.0), rec(0, 0.5, 1.0), rec(None, 3.0, 3.5)]
    assert layers.setup_program_s(recs) == pytest.approx(2.5)
