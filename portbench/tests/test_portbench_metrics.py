"""The metric arithmetic on synthetic inputs."""

import numpy as np
import pytest
import torch

from portbench.harness import roofline, stats
from portbench.harness.readers import idle_share, kernels_per_request
from portbench.harness.runner import Run, Window
from portbench.harness.spec import metric_reader
from portbench.harness.trace import Trace


@pytest.mark.parametrize("q", [50, 90, 95, 99])
def test_percentile_over_all_requests(q):
    v = list(np.random.default_rng(q).exponential(40.0, 997))
    assert stats.percentile(v, q) == pytest.approx(np.percentile(v, q),
                                                   rel=1e-12)


def test_tail_metric_reads_every_request():
    win = Window()
    win.latency_ms = [10.0] * 94 + [100.0] * 6
    p95 = metric_reader("cloud_ms_p95").read(Run(win))
    assert p95 == pytest.approx(np.percentile(win.latency_ms, 95))
    assert p95 > 10.0


def test_rates_take_the_whole_window():
    win = Window()
    win.units, win.seconds, win.requests = 3_000_000, 2.5, 10
    assert metric_reader("points_per_s").read(Run(win)) == 1_200_000


def test_interval_union():
    spans = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]
    assert stats.interval_union_us(spans) == 12 + 10 + 1
    assert stats.merged_intervals(spans) == [[0, 12], [20, 30], [40, 41]]
    assert stats.interval_union_us([]) == 0.0


def test_idle_share_and_kernels_per_request():
    tr = Trace()
    tr.profile = {"busy_s": 0.25, "window_s": 1.0, "kernels": 5216,
                  "requests": 2}
    run = Run(Window(), tr)
    assert idle_share(run) == 75.0
    assert kernels_per_request(run) == 2608


def test_train_bytes_by_hand():
    # X (2 floats), Y (D floats) and the mask byte per row; C, Q, bv,
    # alpha and active per slot, in and out; the 7-float row
    B, P, S, D = 3, 5, 4, 1
    state = B * (S * 2 * 4 + S * D * 4 + S * S * 4 * 2 + S)
    assert roofline.train_bytes(B, P, S, D) == \
        B * P * (8 + 4 * D + 1) + 2 * state + 28


def test_train_bound_from_the_references_counts():
    from portbench.reference.config import GPConfig
    from portbench.reference.cuda_kernels import sogp_train as rs
    from portbench.reference.models import sparse_gp as rsg
    from portbench.reference.ops.kernels import RBFParams

    cfg = GPConfig(capacity=4, slots=8, eps_tol=1e-3, s20=0.01)
    B, P = 6, 40
    g = torch.Generator().manual_seed(0)
    X = torch.rand((B, P, 2), generator=g) * 0.15
    Y = torch.sin(20 * X[..., :1])
    mask = torch.rand((B, P), generator=g) < 0.8
    tally = torch.zeros((B, 5), dtype=torch.int64)
    kp = RBFParams(torch.tensor(1.0), torch.tensor(0.01))
    rs.add_points_batch_plain(kp, cfg, rsg.init_batch(cfg, B, "cpu"), X, Y,
                              mask, tally=tally)
    assert int(tally[:, 1].sum()) > 0          # capacity deletions happen
    rows = mask.sum(1).double()
    flops = roofline.train_flops(rows, tally[:, 3].double(),
                                 tally[:, 4].double(),
                                 float(tally[:, 1].sum()), cfg.capacity, 1)
    a = cfg.capacity + 1
    s1, s2, n = (float(t.sum()) for t in (tally[:, 3], tally[:, 4], rows))
    want = (8 * s1 + 4 * s2 + 9 * s1 + 7 * (s2 + 2 * s1 + n) + 40 * n
            + float(tally[:, 1].sum()) * (3 * a + 7 * a * a + 2 * a))
    assert flops == pytest.approx(want, rel=1e-12)
    b = roofline.train_bound_ms(B, P, cfg.slots, 1, cfg.capacity, mask,
                                tally)
    t_bytes = roofline.train_bytes(B, P, cfg.slots, 1) / 3.35e12 * 1e3
    assert b["ms"] == pytest.approx(max(t_bytes, flops / 67e12 * 1e3))
    assert b["by"] in ("bytes", "operations")


def test_roofline_reader_counts_only_checked_inputs():
    """The kernel's device time from the profiled requests whose clouds
    have a least time; other operations and other clouds left out."""
    tr = Trace()
    kern = "void sogp_train_kernel<1, 1>(float const*)"
    tr.profile = {"device_s": {
        5: (0, {kern: 0.4e-3, "void sogp_train_kernel<3, 1>()": 0.6e-3,
                "elementwise": 9.0}),
        6: (1, {kern: 9.0}),
        8: (0, {kern: 1.0e-3})}}
    tr.bounds_ms["sogp_train"] = {0: 0.02}
    v = metric_reader("sogp_train_roofline").read(Run(Window(), tr))
    assert v == pytest.approx(100 * 0.04 / 2.0)
    tr.bounds_ms["sogp_train"] = {}
    assert metric_reader("sogp_train_roofline").read(Run(Window(), tr)) \
        is None
