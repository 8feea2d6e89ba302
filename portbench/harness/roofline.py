"""The table of peaks and the least time of a training launch.

The SOGP training kernel's least time is the larger of two bounds
against the H100 SXM data-sheet peaks (the card's power limit is printed
beside every run): its bytes, each input read once and each output
written once, counted from the banks' and states' shapes, over the HBM
rate; and its operations over the fp32 rate outside the tensor cores,
counted from the reference's own work counts (the plain trainer's
per-patch tally of the BV count each row starts with, its square, and
the capacity deletions), so that the bound reads the same work whatever
implements the layer. The arithmetic is the port's smoke script's
`train_bound` (`chip_smoke.py`), with the operations counted from the
reference instead of from the program's output.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (dense, no sparsity), at a 700 W limit
PEAK_BYTES = 3.35e12          # HBM3 bytes/s
PEAK_FP32 = 67e12             # fp32 FLOP/s outside the tensor cores


def train_bytes(B: int, P: int, S: int, D: int) -> float:
    """Bytes of one launch on [B, P] banks with S slots and D outputs:
    X, Y and the mask read once, the input state read once and the output
    state written once, and the float32[7] hyperparameter row."""
    state = B * S * (2 * 4 + D * 4 + 2 * S * 4 + 1)
    return B * P * (2 * 4 + D * 4 + 1) + 2 * state + 7 * 4


def train_flops(rows, s1, s2, deletions: float, capacity: int,
                D: int) -> float:
    """Operations of one launch from the reference's counts: per valid row
    that starts with a BVs, 8a for k, 4a^2 for C k and Q k, (4 + 5D)a for
    the sums and alpha, 7(a+1)^2 for the rank-1 updates of C and Q and ~40
    for the scalars; per capacity deletion, (D + 2)a for the scores and
    7a^2 + 2Da for the downdates of C, Q and alpha, at a = capacity + 1.
    rows, s1, s2: per-patch sums over valid rows of 1, a and a^2 (float64
    tensors); deletions: their total."""
    a_del = capacity + 1
    del_flops = deletions * ((D + 2) * a_del + 7 * a_del ** 2
                             + 2 * D * a_del)
    return float((8 * s1 + 4 * s2 + (4 + 5 * D) * s1
                  + 7 * (s2 + 2 * s1 + rows) + 40 * rows).sum()) + del_flops


def train_bound_ms(B: int, P: int, S: int, D: int, capacity: int, mask,
                   tally) -> dict:
    """The least time (ms) of one launch, and what binds it. mask: the
    banks' [B, P] validity; tally: the reference trainer's [B, 5] counts
    on the same banks (BVs added, capacity deletions, geometric
    deletions, sum of a, sum of a^2)."""
    rows = mask.sum(1).double()
    flops = train_flops(rows, tally[:, 3].double(), tally[:, 4].double(),
                        float(tally[:, 1].double().sum()), capacity, D)
    nbytes = train_bytes(B, P, S, D)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return {"bytes": nbytes, "flops": flops, "ms": max(t_bytes, t_ops),
            "by": "bytes" if t_bytes >= t_ops else "operations"}
