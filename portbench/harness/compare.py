"""The numbers that decide `correct`, from the program's outputs and the
reference's on the same inputs.

A round trip (the compressed cloud and its decompression) is judged by:

  * claims_differ  share of the cloud's points whose claiming patch
                   differs (the front end's claims);
  * frame_gap      widest gap over the patches of an entry of the
                   rotation (the plane frame) or of the mean over the
                   voxel edge (the front end's frames);
  * bank_differ    share of the [B, P] bank slots whose validity differs
                   (the front end's banks);
  * emit_differ    patches that emit points in one and not the other, as
                   a share of the patches the reference emits (training
                   and sanitize);
  * depth_gap_mm   widest distance between a decompressed point and the
                   reference's, over the patches both emit, in mm
                   (training, prediction, reprojection);
  * depth_gap_p99_mm  its 99th percentile over those points (a patch that
                   float32 training leaves astray moves the widest gap,
                   not this);
  * color_gap      widest gap of a decompressed colour, 0-255 units.
"""

from __future__ import annotations

import torch


def _max(t: torch.Tensor) -> float:
    return float(t.max()) if t.numel() else 0.0


def _q99(t: torch.Tensor) -> float:
    return float(torch.quantile(t, 0.99)) if t.numel() else 0.0


def round_trip(prog_comp, prog_out, ref_comp, ref_out, res: float) -> dict:
    pb, rb = prog_comp.patch, ref_comp.patch
    L = int(rb.n_leaves)
    claims = (pb.claims.long() != rb.claims.long()).double().mean()
    R = (pb.rotations[:L].double() - rb.rotations[:L].double()).abs()
    M = (pb.means[:L].double() - rb.means[:L].double()).abs() / res
    frame = max(_max(R), _max(M))
    bank = (pb.mask != rb.mask).double().mean()
    pw, pc, _, _, _, pok = prog_out
    rw, rc, _, _, _, rok = ref_out
    emit = float((pok != rok).sum()) / max(int(rok.sum()), 1)
    both = (pok & rok)
    G = pw.shape[0] // pok.shape[0]
    sel = both[:, None].expand(-1, G).reshape(-1)
    d = torch.linalg.norm(pw[sel].double() - rw[sel].double(), dim=1) * 1e3
    c = (pc[sel].double() - rc[sel].double()).abs()
    return {"claims_differ": float(claims), "frame_gap": frame,
            "bank_differ": float(bank), "emit_differ": emit,
            "depth_gap_mm": _max(d), "depth_gap_p99_mm": _q99(d),
            "color_gap": _max(c)}


def worst(readings) -> dict:
    """Per number, the largest over several requests' readings (NaN, the
    sign of a non-finite output, wins)."""
    out = {}
    for r in readings:
        for k, v in r.items():
            if k not in out or v != v or (out[k] == out[k] and v > out[k]):
                out[k] = v
    return out
