"""The four training regimes that hold a SOGP trainer against a reference.

The same inputs and acceptance rules as the JAX package's
`tests/test_pallas_sogp.py`, shared by the CPU tests (port against JAX),
the card test and `chip_smoke.py` (kernel against its plain version):

  * strict_d1 / strict_d3 — well-separated points, ample capacity: no
    deletions and robust branch decisions, so the states agree to float32
    accumulation error (identical `active`; atol 1e-4, rtol 1e-3).
  * realistic — smooth depth surfaces with capacity churn (capacity 8):
    per-op rounding can flip chaotic deletion choices in a few patches, so
    agreement is statistical (sizes on > 90% of patches, median prediction
    gap < 5e-3, in-sample RMSE within 20%).
  * geometric — GPConfig.novelty_mode="geometric": identical `active`, BV
    picks identical on >= 95% of patches, predictions agree there.

A fifth rule, `bench`, holds a trainer against another on real banks
that never reach capacity (the bench configuration's): the strict state
rule plus a maximum prediction gap < 1e-3 on the valid training inputs.

A sixth, `nan`, holds a trainer that starts from a state with one NaN in
one patch's active C (`nan_case`): every array's NaN pattern must be
equal, and the other patches agree by the strict rule.

A seventh, `calibrated`, holds a trainer against another at the
calibrated round trip's hyperparameters (`calibrated_case`, or the bench
banks with the calibrated row). There l ~ 3.7 cm under a 15 cm patch, so
patches fill toward capacity and delete on most rows, and the novelty
threshold (2% of sigma_f^2) sits where float32's cancellation in
gamma = k** - k^T Q k can flip an admission. One flipped admission
changes the BVs every later row of the patch sees, so the realistic
rule's "same size on > 90%" does not fit (`compare` returns the share
that does agree), nor do its absolute gaps for colour targets. A few
patches may also leave training non-finite, or finite but far off, in
either trainer (the round trip's sanitize pass resets the first kind),
so one patch can move a bank's in-sample RMSE by tens of percent. So: at
most max(2, 1%) non-finite patches in each; on the patches finite in
both, sizes within 2 BVs on > 90%, mean sizes within 2%, the median
per-patch in-sample RMSE within 5%, and a median prediction gap at the
training inputs below 5% of the targets' RMS.

An eighth, `arbitrated` (`arbitrate`), holds a float32 trainer where
float32 itself cannot resolve the regime: gp-accuracy's reference
constants (sigma_f^2 100, l^2 1, eps_tol 1e-6) over 0.3 m patches, where
gamma = k** - k^T Q k cancels to rounding after a few BVs and most
patches of either float32 trainer end non-finite or far off, each at its
own patches. The plain version in float64 on the same inputs is the
referee: a patch is astray when it is non-finite or its in-sample RMSE
exceeds 1.5x the float64 patch's plus 10% of the float64 median. The
trainer under test may leave at most max(2, 1%) more patches with points
astray than the float32 plain version does.

Inputs are numpy arrays made from a fixed seed, so every framework gets
the same bytes. `compare` raises AssertionError with the failing metric.
"""

from __future__ import annotations

import numpy as np
import torch

from gp_compressor_tpu_torch.config import GPConfig
from gp_compressor_tpu_torch.models import sparse_gp
from gp_compressor_tpu_torch.models.sparse_gp import SOGPState
from gp_compressor_tpu_torch.ops.kernels import RBFParams

SIGMAF_SQ, L_SQ, S20 = 100.0, 1.0, 0.1
REGIMES = ("strict_d1", "strict_d3", "realistic", "geometric")
# state sizes the card runs the strict regimes at: partial warps and 1 to 4
# slots per lane of the training kernel
SLOT_SWEEP = (8, 16, 31, 32, 33, 64, 100, 128)
NAN_PATCH = 5
# the calibrated round trip's depth hyperparameters on the bench cloud,
# as the JAX package fits them on the CPU in float32 (port_anchors.py):
# sigma_f^2, l^2, s20, and the novelty threshold rescaled with sigma_f^2
# (eps_tol 2.0 at sigma_f^2 100)
CAL_SIGMAF_SQ, CAL_L_SQ, CAL_S20 = 1.0375e-3, 1.3576e-3, 4.3595e-4
CAL_EPS = 2.0 * CAL_SIGMAF_SQ / 100.0


def calibrated_params(device="cuda") -> RBFParams:
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return RBFParams(sigmaf_sq=t(CAL_SIGMAF_SQ), l_sq=t(CAL_L_SQ))


def calibrated_case(dout: int = 1, B: int = 64, P: int = 256):
    """(cfg, X [B,P,2] f32, Y [B,P,D] f32, mask [B,P] bool) at the bench's
    32 slots and capacity 30, for training at the calibrated
    hyperparameters (calibrated_params, CAL_S20, CAL_EPS): smooth depth
    surfaces over a 15 cm patch with 2 cm noise (sqrt of CAL_S20), so that
    patches fill to capacity and delete, as the calibrated bench banks
    do."""
    r = np.random.default_rng(13)
    cfg = GPConfig(capacity=30, slots=32, dout=dout, eps_tol=2.0)
    X = r.uniform(-0.075, 0.075, size=(B, P, 2)).astype(np.float32)
    f = [0.03 * np.sin(8 * X[..., 0]) + 0.02 * np.cos(11 * X[..., 1]),
         0.04 * np.cos(9 * X[..., 0] * X[..., 1] * 40),
         0.02 * np.sin(13 * X[..., 1])][:dout]
    Y = (np.stack(f, axis=-1)
         + 0.02 * r.standard_normal((B, P, dout))).astype(np.float32)
    mask = r.uniform(size=(B, P)) > 0.05
    return cfg, X, Y, mask


def regime(name: str, slots: int = 16, capacity: int = 14, seed: int = 0,
           points: int = 12):
    """(cfg, X [B,P,2] f32, Y [B,P,D] f32, mask [B,P] bool) for a regime.
    slots resizes the state of every regime; capacity (capped at
    slots - 1), seed and points (P, the bank rows; ~80% valid) apply to
    the strict regimes."""
    if name in ("strict_d1", "strict_d3"):
        dout = 1 if name == "strict_d1" else 3
        r = np.random.default_rng(seed)
        B, P = 130, points
        capacity = min(capacity, slots - 1)
        cfg = GPConfig(capacity=capacity, slots=slots, dout=dout,
                       eps_tol=1e-4)
        X = r.uniform(-20, 20, size=(B, P, 2)).astype(np.float32)
        Y = r.normal(size=(B, P, dout)).astype(np.float32)
        mask = r.uniform(size=(B, P)) > 0.2
        return cfg, X, Y, mask
    if name == "realistic":
        r = np.random.default_rng(3)
        B, P = 140, 80
        cfg = GPConfig(capacity=8, slots=slots, dout=1, eps_tol=2.0)
        X = r.uniform(-0.075, 0.075, size=(B, P, 2)).astype(np.float32)
        f = 0.03 * np.sin(8 * X[..., 0]) + 0.02 * np.cos(11 * X[..., 1])
        Y = (f + 0.004 * r.standard_normal((B, P)))[..., None] \
            .astype(np.float32)
        return cfg, X, Y, np.ones((B, P), bool)
    if name == "geometric":
        r = np.random.default_rng(7)
        B, P = 130, 40
        half = 0.15 / 2
        cfg = GPConfig(capacity=14, slots=slots, dout=1,
                       novelty_mode="geometric", geom_dmin=0.05,
                       geom_max_bv=3, geom_gamma_min_rel=1e-2)
        X = r.uniform(-half, half, size=(B, P, 2)).astype(np.float32)
        Y = (0.01 * r.normal(size=(B, P, 1))).astype(np.float32)
        mask = r.uniform(size=(B, P)) > 0.1
        return cfg, X, Y, mask
    raise ValueError(f"unknown regime {name!r}")


def nan_case():
    """(cfg, first, second): two passes of strict_d1 inputs at the bench's
    32 slots (seeds 0 and 1), each an (X, Y, mask) triple. Train `first`
    from an empty state, put NaN into it with `poison`, then train
    `second` on it with both trainers and compare by the `nan` rule."""
    cfg, *first = regime("strict_d1", slots=32, capacity=30)
    second = regime("strict_d1", slots=32, capacity=30, seed=1)[1:]
    return cfg, tuple(first), tuple(second)


def poison(state: SOGPState) -> SOGPState:
    """A copy of `state` with NaN at C[NAN_PATCH, i, i] of that patch's
    first active slot i."""
    i = int(torch.nonzero(state.active[NAN_PATCH])[0])
    C = state.C.clone()
    C[NAN_PATCH, i, i] = float("nan")
    return state._replace(C=C)


def division_cases(n_random: int = 1 << 20):
    """(a, b) float32 arrays for holding the kernel's inline division to
    IEEE a / b: every pair of signed zeros, denormals, the fast path's
    range limits (2^-60, 2^61), ordinary, huge and infinite values and
    NaN; then random bit patterns (all magnitudes) and random normal
    values (the fast path), n_random pairs each."""
    edge = np.array([0.0, 1e-45, 3e-39, 1.1754944e-38, 2.0 ** -61, 2.0 ** -60,
                     1e-7, 0.1, 1.0, 1.5, 3.0, 100.0, 2.0 ** 60, 2.0 ** 61,
                     2.0 ** 126, 3.4028235e38, np.inf], np.float32)
    edge = np.concatenate([edge, -edge, [np.nan]]).astype(np.float32)
    a, b = (v.ravel() for v in np.meshgrid(edge, edge))
    r = np.random.default_rng(11)
    bits = r.integers(0, 2 ** 32, size=(2, n_random), dtype=np.uint64)
    ra, rb = bits.astype(np.uint32).view(np.float32)
    na, nb = (r.normal(size=(2, n_random))
              * 10.0 ** r.integers(-8, 9, size=(2, n_random))).astype(np.float32)
    return np.concatenate([a, ra, na]), np.concatenate([b, rb, nb])


def geometric_probes() -> np.ndarray:
    """The 24 footprint probes the geometric regime's check predicts at
    (drawn after the regime's inputs from the same generator)."""
    r = np.random.default_rng(7)
    half = 0.15 / 2
    r.uniform(-half, half, size=(130, 40, 2))
    r.normal(size=(130, 40, 1))
    r.uniform(size=(130, 40))
    return r.uniform(-half, half, size=(24, 2)).astype(np.float32)


def params(device="cuda") -> RBFParams:
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return RBFParams(sigmaf_sq=t(SIGMAF_SQ), l_sq=t(L_SQ))


def _np(state: SOGPState):
    return SOGPState(*[a.detach().cpu().numpy() for a in state])


def _rmse(kp, s20, state, X, Y, mask):
    m, _ = sparse_gp.predict_batch(kp, s20, state, X)
    err = (m - Y).double() ** 2
    return float(torch.sqrt(err[mask].mean()))


def patch_rmse(kp: RBFParams, s20, state: SOGPState, X: torch.Tensor,
               Y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B] float64 in-sample RMSE per patch over its valid rows (inf where
    the state is non-finite, 0 where the patch has no rows)."""
    m, _ = sparse_gp.predict_batch(kp, s20, state, X)
    e2 = torch.where(mask, ((m.double() - Y.double()) ** 2).mean(-1), 0.0)
    r = torch.sqrt(e2.sum(1) / mask.sum(1).clamp(min=1))
    fin = torch.ones_like(r, dtype=torch.bool)
    for leaf in (state.alpha, state.C, state.Q):
        fin &= torch.isfinite(leaf).flatten(1).all(1)
    return torch.where(fin, r, torch.inf)


def arbitrate(ref64: SOGPState, ref: SOGPState, out: SOGPState,
              X: torch.Tensor, Y: torch.Tensor, mask: torch.Tensor,
              kp: RBFParams, s20) -> dict:
    """The `arbitrated` rule: `out` (float32) against `ref` (the float32
    plain version), both against `ref64` (the plain version in float64
    on the same inputs; kp and s20 in float32). Returns the astray and
    non-finite counts, mean BV counts and median patch RMSEs over patches
    with points; raises AssertionError."""
    used = mask.any(1)
    kp64 = RBFParams(sigmaf_sq=torch.as_tensor(kp.sigmaf_sq).double(),
                     l_sq=torch.as_tensor(kp.l_sq).double())
    base = patch_rmse(kp64, torch.as_tensor(s20).double(), ref64,
                      X.double(), Y, mask)[used]
    med = float(base[torch.isfinite(base)].median())
    res = {"patches_with_points": int(used.sum()), "median_rmse_f64": med}
    for name, st in (("f64", ref64), ("plain", ref), ("out", out)):
        r = base if name == "f64" else \
            patch_rmse(kp, s20, st, X, Y, mask)[used]
        astray = ~torch.isfinite(r) | (r > 1.5 * base + 0.1 * med)
        fin = r[torch.isfinite(r)]
        res[name] = {"astray": int(astray.sum()),
                     "non_finite": int((~torch.isfinite(r)).sum()),
                     "mean_bvs": float(sparse_gp.size(st)[used]
                                       .double().mean()),
                     "median_rmse": float(fin.median()) if len(fin)
                     else None}
    slack = max(2, 0.01 * res["patches_with_points"])
    assert res["out"]["astray"] <= res["plain"]["astray"] + slack, \
        f"astray patches {res['out']['astray']} against the plain " \
        f"version's {res['plain']['astray']} (+{slack})"
    return res


def _same_state(a: SOGPState, b: SOGPState) -> float:
    """The strict rule: identical `active`, bv/alpha/C/Q allclose (atol
    1e-4, rtol 1e-3). Returns the largest absolute state difference."""
    diff = (a.active != b.active).any(1)
    assert not diff.any(), f"active differs on {int(diff.sum())} patches"
    err = 0.0
    for f in ("bv", "alpha", "C", "Q"):
        x, y = getattr(a, f), getattr(b, f)
        d = float(np.abs(x - y).max())
        bad = ~np.isclose(x, y, atol=1e-4, rtol=1e-3)
        assert not bad.any(), (f"{f}: {int(bad.sum())} entries outside atol "
                               f"1e-4 rtol 1e-3, max |d| {d}")
        err = max(err, d)
    return err


def compare(name: str, ref: SOGPState, out: SOGPState, X: torch.Tensor,
            Y: torch.Tensor, mask: torch.Tensor, kp: RBFParams = None,
            s20: float = S20) -> dict:
    """Hold `out` against `ref` (same inputs, same device) by the rule
    `name`. kp / s20 default to the regimes' hyperparameters. Returns the
    measured agreement; raises AssertionError."""
    kp = params(X.device) if kp is None else kp
    a, b = _np(ref), _np(out)
    if name.startswith("strict"):
        return {"max_abs_err": _same_state(a, b)}
    if name == "bench":
        err = _same_state(a, b)
        m1, _ = sparse_gp.predict_batch(kp, s20, ref, X)
        m2, _ = sparse_gp.predict_batch(kp, s20, out, X)
        gap = float((m1 - m2).abs()[mask].max())
        assert gap < 1e-3, f"max prediction gap {gap}"
        return {"max_abs_err": err, "max_pred_gap": gap}
    if name == "nan":
        for f in SOGPState._fields:
            x, y = getattr(a, f), getattr(b, f)
            if x.dtype != np.bool_:
                assert np.array_equal(np.isnan(x), np.isnan(y)), \
                    f"{f}: NaN patterns differ"
        assert np.isnan(b.C[NAN_PATCH]).any(), "the NaN did not spread"
        keep = np.arange(a.C.shape[0]) != NAN_PATCH
        err = _same_state(SOGPState(*[v[keep] for v in a]),
                          SOGPState(*[v[keep] for v in b]))
        return {"max_abs_err": err,
                "nan_entries": int(np.isnan(b.C[NAN_PATCH]).sum())}
    if name == "realistic":
        same_size = float((a.active.sum(1) == b.active.sum(1)).mean())
        assert same_size > 0.9, f"sizes agree on {same_size}"
        r1 = _rmse(kp, s20, ref, X, Y, mask)
        r2 = _rmse(kp, s20, out, X, Y, mask)
        assert abs(r1 - r2) < 0.2 * max(r1, 1e-3), (r1, r2)
        m1, _ = sparse_gp.predict_batch(kp, s20, ref, X)
        m2, _ = sparse_gp.predict_batch(kp, s20, out, X)
        d = (m1 - m2).abs()
        med = float(d.median())
        assert med < 5e-3, f"median prediction gap {med}"
        return {"same_size": same_size, "rmse_ref": r1, "rmse_out": r2,
                "median_gap": med, "max_abs_err": float(d.max())}
    if name == "calibrated":
        used = mask.any(1).cpu().numpy()
        fin = [np.isfinite(s.alpha).all((1, 2)) & np.isfinite(s.C).all((1, 2))
               & np.isfinite(s.Q).all((1, 2)) for s in (a, b)]
        n_bad = [int((~f & used).sum()) for f in fin]
        assert max(n_bad) <= max(2, 0.01 * used.sum()), \
            f"non-finite patches {n_bad} of {int(used.sum())}"
        keep = fin[0] & fin[1]
        n1, n2 = a.active.sum(1)[keep], b.active.sum(1)[keep]
        near = float((np.abs(n1 - n2) <= 2).mean())
        assert near > 0.9, f"sizes within 2 BVs on {near}"
        mean1, mean2 = float(n1.mean()), float(n2.mean())
        assert abs(mean1 - mean2) <= 0.02 * mean1, (mean1, mean2)
        kt = torch.as_tensor(keep, device=X.device)
        Yk, Mk = Y[kt], mask[kt]
        has = Mk.any(1)
        m = [sparse_gp.predict_batch(kp, s20, st, X)[0][kt]
             for st in (ref, out)]
        per_patch = []
        for mi in m:
            e2 = torch.where(Mk, ((mi - Yk).double() ** 2).mean(-1), 0.0)
            per_patch.append(torch.sqrt(e2.sum(1) / Mk.sum(1).clamp(min=1)
                                        )[has])
        p1, p2 = (float(p.median()) for p in per_patch)
        assert abs(p1 - p2) < 0.05 * p1, f"median patch RMSE {p1}, {p2}"
        d = (m[0] - m[1]).abs()[Mk]
        y_rms = float(torch.sqrt((Yk[Mk].double() ** 2).mean()))
        med = float(d.median())
        assert med < 0.05 * y_rms, f"median prediction gap {med}, targets' " \
                                   f"RMS {y_rms}"
        return {"non_finite": n_bad, "same_size": float((n1 == n2).mean()),
                "within_2": near, "mean_size": [mean1, mean2],
                "median_patch_rmse": [p1, p2],
                "worst_patch_rmse": [float(p.max()) for p in per_patch],
                "median_gap": med, "y_rms": y_rms,
                "max_abs_err": float(d.max())}
    if name == "geometric":
        cfg = regime("geometric")[0]
        assert np.array_equal(a.active, b.active), "active differs"
        same = np.all(a.bv == b.bv, axis=(1, 2))
        assert same.mean() >= 0.95, f"same BV picks on {same.mean()}"
        probes = torch.as_tensor(geometric_probes(), device=X.device)
        Bp = probes.expand(X.shape[0], -1, -1)
        m1, _ = sparse_gp.predict_batch(kp, S20, ref, Bp)
        m2, _ = sparse_gp.predict_batch(kp, S20, out, Bp)
        dm = (m1 - m2).abs()[torch.as_tensor(same, device=X.device)]
        assert float(dm.median()) < 1e-3, float(dm.median())
        assert float(dm.max()) < 2e-2, float(dm.max())
        e1 = _rmse(kp, S20, ref, X, Y, mask)
        e2 = _rmse(kp, S20, out, X, Y, mask)
        assert abs(e1 - e2) < 0.1 * max(e1, e2), (e1, e2)
        for st in (a, b):
            for leaf in (st.alpha, st.C, st.Q):
                assert np.isfinite(leaf).all(), "non-finite state"
        # selection invariants: budget respected, pairwise separation >= dmin
        for st in (a, b):
            sizes = st.active.sum(1)
            assert sizes.max() <= cfg.geom_max_bv and sizes.min() >= 1
            for bv, act in zip(st.bv, st.active):
                pts = bv[act]
                if len(pts) >= 2:
                    dd = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
                    np.fill_diagonal(dd, np.inf)
                    assert dd.min() >= cfg.geom_dmin - 1e-6
        return {"same_bv": float(same.mean()),
                "median_gap": float(dm.median()),
                "max_abs_err": float(dm.max())}
    raise ValueError(f"unknown regime {name!r}")
