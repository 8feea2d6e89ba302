"""The numbers that decide `correct` for the dictionary codec's round trip.

K-SVD is greedy: one rounding can change an atom choice and from there
the whole learnt dictionary, so the program's dictionaries are not
compared with the reference's. Each stage is judged instead on what the
program itself produced, as the reference computes it from the same
inputs:

  * front end, against the reference's raster of the same cloud:
    claims_differ   share of the points whose claiming patch differs;
    frame_gap       widest gap of a rotation entry, or of a patch centre
                    over the voxel edge;
    cell_differ     share of the [B, G] cells whose occupancy (an occupied
                    cell of a row that is a patch) differs;
    raster_gap_mm   widest gap of a cell's demeaned depth (mm), over the
                    cells occupied in both;
    raster_color_gap  the same for its colour (0-255 units);
  * encoding, the reference's OMP of the program's raster with the
    program's final dictionaries:
    omp_differ      share of the valid depth and colour rows whose atom
                    lists differ;
    coef_gap        widest coefficient gap over the rows that agree,
                    relative to the row's largest coefficient;
  * error: mse_gap, the program's final masked MSE against the reference's
    masked MSE of the program's dictionary and codes (relative; the
    larger of depth and colour);
  * quality: rms_excess_depth and rms_excess_color, the program's
    in-sample RMS over the RMS of the reference's own K-SVD of the same
    cloud with the same draws, minus 1, and 0 where the program is the
    better;
  * decode, the reference's decompression of the program's compressed
    state: decode_gap_mm (widest distance of a decompressed point, mm)
    and decode_color_gap.

A non-finite coefficient or decompressed point is a failure (NaN) unless
the reference gives one at the same row or point. `nonfinite_rows`, the
rows with a non-finite coefficient in a used word, is reported beside the
numbers and limits nothing.
"""

from __future__ import annotations

import torch

NAN = float("nan")


def _max(t: torch.Tensor) -> float:
    return float(t.max()) if t.numel() else 0.0


def largest(values) -> float:
    """The largest of several readings, NaN (a failed one) winning."""
    return max(values, key=lambda v: (v != v, v))


def front_end(prog, ref, res: float) -> dict:
    """prog, ref: rasters (the program's and the reference's)."""
    L = int(ref.n_leaves)
    rows = torch.arange(ref.W.shape[0], device=ref.W.device)[:, None]
    occ = [r.W & (rows < int(r.n_leaves)) for r in (prog, ref)]
    claims = (prog.claims.long() != ref.claims.long()).double().mean()
    rot = (prog.rotations[:L].double() - ref.rotations[:L].double()).abs()
    cen = (prog.means[:L].double() - ref.means[:L].double()).abs() / res
    both = (prog.W & ref.W)[:L]
    dS = (prog.S[:L].double() - ref.S[:L].double()).abs()[both] * 1e3
    dC = (prog.RGB[:L].double() - ref.RGB[:L].double()).abs()[both]
    return {"claims_differ": float(claims),
            "frame_gap": max(_max(rot), _max(cen)),
            "cell_differ": float((occ[0] != occ[1]).double().mean()),
            "raster_gap_mm": _max(dS), "raster_color_gap": _max(dC)}


def _finite_rows(code) -> torch.Tensor:
    use = torch.arange(code.X.shape[1], device=code.X.device)[None, :] \
        < code.nw[:, None]
    return torch.all(torch.isfinite(code.X) | ~use, dim=1)


def encoding(prog_code, ref_code, valid) -> dict:
    """The program's code of one problem against the reference's OMP of the
    same rows with the same dictionary (valid: [n] bool rows compared).
    Returns the rows compared, those that differ, the widest relative
    coefficient gap, and the rows with a non-finite coefficient."""
    kmax = prog_code.X.shape[1]
    use = torch.arange(kmax, device=prog_code.X.device)[None, :] \
        < ref_code.nw[:, None]
    same = (prog_code.nw.long() == ref_code.nw.long()) & torch.all(
        (prog_code.I.long() == ref_code.I.long()) | ~use, dim=1) & valid
    pf, rf = _finite_rows(prog_code), _finite_rows(ref_code)
    rows = same & pf & rf
    X = torch.where(use, prog_code.X.double(), 0.0)[rows]
    Y = torch.where(use, ref_code.X.double(), 0.0)[rows]
    scale = torch.clamp(Y.abs().amax(dim=1), min=1e-30)
    gap = _max((X - Y).abs().amax(dim=1) / scale)
    if bool(torch.any(valid & ~pf & rf)):
        gap = NAN                      # non-finite where the reference is not
    return {"rows": int(valid.sum()), "differ": int((valid & ~same).sum()),
            "coef_gap": gap, "nonfinite": int((valid & ~pf).sum())}


def mse_gap(prog_error, ref_error) -> float:
    p, r = float(prog_error), float(ref_error)
    if p != p or r != r:
        return NAN if (p != p) != (r != r) else 0.0
    return abs(p - r) / max(abs(r), 1e-30)


def rms_excess(prog_rms: float, ref_rms: float) -> float:
    if prog_rms != prog_rms:
        return NAN
    return max(0.0, prog_rms / max(ref_rms, 1e-30) - 1.0)


def decode(prog_out, ref_out) -> dict:
    """The program's decompressed cloud against the reference's
    decompression of the program's compressed state."""
    pw, pc, pok = prog_out
    rw, rc, rok = ref_out
    if not torch.equal(pok.cpu(), rok.cpu()):
        return {"decode_gap_mm": NAN, "decode_color_gap": NAN}
    pw, rw = pw[pok].double(), rw[rok].double()
    pc, rc = pc[pok].double(), rc[rok].double()
    out = {}
    for name, a, b, scale, dist in (
            ("decode_gap_mm", pw, rw, 1e3, True),
            ("decode_color_gap", pc, rc, 1.0, False)):
        fa = torch.all(torch.isfinite(a), dim=1)
        fb = torch.all(torch.isfinite(b), dim=1)
        if bool(torch.any(fa != fb)):
            out[name] = NAN
            continue
        d = a[fa] - b[fa]
        d = torch.linalg.norm(d, dim=1) if dist else d.abs()
        out[name] = _max(d * scale)
    return out

