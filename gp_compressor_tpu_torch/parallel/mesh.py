"""The (data x chain) device mesh, and the rows each rank owns on it.

The counterpart of `gp_compressor_tpu.parallel.mesh`. The JAX package
annotates shardings and lets XLA insert the collectives; here every rank
runs the same program on explicit shards (SPMD) and calls the collectives
itself, on the process groups of a `torch.distributed` `DeviceMesh` with
the named dims (data, chain):

  * `data`  - the patch bank's leading axis is cut into contiguous row
    blocks, one per data coordinate; every per-patch op is local, and the
    global sums (RMSE, registration's twist) are one all-reduce over the
    data group. The cloud's point axis is cut the same way (`point_rows`,
    JAX's P('data') on the points): the front end's global results (the
    grid's bounds and leaf keys, the sphere moments) are collectives over
    the data group, and each point is routed to the rank that owns its
    patch row (`all_to_all_rows`).
  * `chain` - independent MAP starts and HMC chains are cut the same way
    over the chain coordinate and all-gathered in chain order.

Tensors that are not cut are whole on every rank (replicated). No DTensor:
the front end is sorts, scatters and segment sums over points, which
DTensor does not partition, and explicit shards say which rows a rank owns.
Every collective here is over the group of one named axis (`data` by
default), and every rank of that group must call it, in the same order.

Name for name:

  =============================  ======================================
  gp_compressor_tpu             here
  =============================  ======================================
  make_mesh(cfg, devices)        make_mesh(cfg, device_type): a DeviceMesh
                                 over the joined process group
  patch_sharding(mesh)           patch_rows(B, mesh): the slice of the
                                 patch axis this rank owns
  P('data') on the points        point_rows(N, mesh), point_block(t, mesh):
                                 this rank's block of the padded point axis
  replicated(mesh)               data_group(mesh): a whole tensor needs no
                                 placement; this is the group its
                                 patch-axis sums all-reduce over
  chain_sharding(mesh)           chain_group(mesh): the group the chains
                                 are cut over
  shard_patch_batch(tree, mesh)  shard_patch_batch(tree, mesh)
  pad_to_multiple(n, m)          pad_to_multiple(n, m)
  constrain_leading(tree, ...)   shard_leading(tree, mesh, dim, axis)
                                 and its inverse gather_leading
  (psum inside jit)              all_reduce_sum(t, mesh, axis)
  (GSPMD's min / max, unique     all_reduce_min / all_reduce_max,
  and sort over a cut axis)      all_gather_varlen, all_to_all_rows
  =============================  ======================================

A cut axis must divide evenly, as a JAX `NamedSharding` requires:
`pad_to_multiple` gives the size to pad to (`point_block` pads the point
axis itself, with rows that the caller marks invalid).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from gp_compressor_tpu_torch.config import MeshConfig


def make_mesh(cfg: MeshConfig = MeshConfig(),
              device_type: str = "cuda") -> DeviceMesh:
    """A (data, chain) mesh over every rank of the joined process group,
    rank r at coordinate (r // chain, r % chain)."""
    n = dist.get_world_size()
    chain = max(1, cfg.chain_size)
    data = cfg.data_size if cfg.data_size is not None else n // chain
    if data * chain != n:
        raise ValueError(f"mesh {data}x{chain} does not cover {n} devices")
    return init_device_mesh(device_type, (data, chain),
                            mesh_dim_names=(cfg.data_axis, cfg.chain_axis))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along `axis` (its rank in that group)."""
    return mesh.get_local_rank(axis)


def data_group(mesh: DeviceMesh, data_axis: str = "data"):
    return mesh.get_group(data_axis)


def chain_group(mesh: DeviceMesh, chain_axis: str = "chain"):
    return mesh.get_group(chain_axis)


def patch_rows(n: int, mesh: DeviceMesh, axis: str = "data") -> slice:
    """The contiguous rows of a leading axis of size n that this rank owns
    along `axis` (the patch axis over `data` by default)."""
    k = axis_size(mesh, axis)
    if n % k:
        raise ValueError(f"a leading axis of {n} does not split over "
                         f"{k} ranks of {axis!r}; pad it to "
                         f"{pad_to_multiple(n, k)}")
    per = n // k
    i = axis_index(mesh, axis)
    return slice(i * per, (i + 1) * per)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _map(fn, tree):
    """fn over the tensor leaves of nested named tuples, tuples, lists and
    dicts; other leaves (None, numbers) pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def shard_leading(tree, mesh: DeviceMesh, dim: int, axis: str = "data"):
    """This rank's rows of every tensor leaf whose leading size is `dim`
    (a compact copy, so the whole tensor can be freed); other leaves
    (scalars, lookup tables, differently shaped tensors) stay whole."""
    rows = patch_rows(dim, mesh, axis)
    return _map(lambda a: a[rows].clone()
                if a.ndim >= 1 and a.shape[0] == dim else a, tree)


def all_gather_rows(t: torch.Tensor, mesh: DeviceMesh,
                    axis: str = "data") -> torch.Tensor:
    """The shards of every rank along `axis`, concatenated in coordinate
    order on the leading axis (bool through uint8, which every backend
    gathers)."""
    group = mesh.get_group(axis)
    src = t.contiguous()
    if src.dtype == torch.bool:
        src = src.view(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    return out.view(torch.bool) if t.dtype == torch.bool else out


def gather_leading(tree, mesh: DeviceMesh, dim: int, axis: str = "data"):
    """The inverse of shard_leading: every tensor leaf whose leading size
    is this rank's share of `dim` is all-gathered into the whole [dim, ...]
    tensor. Every rank must call it on the same tree."""
    per = dim // axis_size(mesh, axis)
    return _map(lambda a: all_gather_rows(a, mesh, axis)
                if a.ndim >= 1 and a.shape[0] == per else a, tree)


def shard_patch_batch(tree, mesh: DeviceMesh, data_axis: str = "data"):
    """This rank's rows of every tensor leaf of a patch-bank tree (leading
    axis = patches)."""
    return _map(lambda a: a[patch_rows(a.shape[0], mesh, data_axis)].clone()
                if a.ndim >= 1 else a, tree)


def _all_reduce(t: torch.Tensor, mesh: DeviceMesh, axis: str, op):
    out = t.clone()
    dist.all_reduce(out, op=op, group=mesh.get_group(axis))
    return out


def all_reduce_sum(t: torch.Tensor, mesh: DeviceMesh,
                   axis: str = "data") -> torch.Tensor:
    """The sum of t over the ranks along `axis`, as a new tensor: one
    collective, whatever t's size."""
    return _all_reduce(t, mesh, axis, dist.ReduceOp.SUM)


def all_reduce_min(t: torch.Tensor, mesh: DeviceMesh,
                   axis: str = "data") -> torch.Tensor:
    """The elementwise minimum of t over the ranks along `axis` (exact)."""
    return _all_reduce(t, mesh, axis, dist.ReduceOp.MIN)


def all_reduce_max(t: torch.Tensor, mesh: DeviceMesh,
                   axis: str = "data") -> torch.Tensor:
    """The elementwise maximum of t over the ranks along `axis` (exact)."""
    return _all_reduce(t, mesh, axis, dist.ReduceOp.MAX)


def point_rows(n: int, mesh: DeviceMesh, axis: str = "data") -> slice:
    """The point-axis counterpart of patch_rows: this rank's contiguous
    block [r * m, (r + 1) * m) of a point axis of n rows padded to
    pad_to_multiple(n, k) = k * m, r its coordinate along `axis` (of size
    k). Rows at or past n are padding."""
    k = axis_size(mesh, axis)
    per = pad_to_multiple(n, k) // k
    i = axis_index(mesh, axis)
    return slice(i * per, (i + 1) * per)


def point_block(t: torch.Tensor, mesh: DeviceMesh, fill=0,
                axis: str = "data") -> torch.Tensor:
    """This rank's block of the leading (point) axis of a whole t, a
    compact copy whose rows past t's end are `fill` (see point_rows)."""
    rows = point_rows(t.shape[0], mesh, axis)
    out = torch.full((rows.stop - rows.start,) + t.shape[1:], fill,
                     dtype=t.dtype, device=t.device)
    part = t[rows.start:min(rows.stop, t.shape[0])]
    out[:part.shape[0]] = part
    return out


def all_gather_varlen(t: torch.Tensor, mesh: DeviceMesh, fill,
                      axis: str = "data") -> torch.Tensor:
    """Every rank's t (1-D, of any length) along `axis`, concatenated in
    coordinate order, each padded with `fill` to the longest: one
    all-reduce of the length, then one all-gather of [k * max] values."""
    m = int(all_reduce_max(torch.tensor([t.shape[0]], device=t.device),
                           mesh, axis))
    padded = torch.full((m,), fill, dtype=t.dtype, device=t.device)
    padded[:t.shape[0]] = t
    return all_gather_rows(padded, mesh, axis)


def all_to_all_rows(tensors, dest: torch.Tensor, mesh: DeviceMesh,
                    axis: str = "data"):
    """Route row i of every tensor in `tensors` (equal leading sizes) to
    the rank whose coordinate along `axis` is dest[i]. Returns the rows
    this rank receives, ordered by source coordinate and, within one
    source, in the source's row order; so when the ranks hold contiguous
    blocks of one axis in order, what a rank receives keeps that axis's
    order. One exchange of the [k] counts, then one all_to_all_single of
    every tensor's rows side by side as bytes (exact for any dtype)."""
    group = mesh.get_group(axis)
    k = axis_size(mesh, axis)
    order = torch.argsort(dest, stable=True)
    send = torch.bincount(dest.long(), minlength=k)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    in_splits, out_splits = send.tolist(), recv.tolist()
    n = dest.shape[0]
    cols = [t.reshape(n, math.prod(t.shape[1:])).contiguous().view(torch.uint8)
            for t in tensors]
    payload = torch.cat(cols, 1)[order]
    got = payload.new_empty((sum(out_splits), payload.shape[1]))
    dist.all_to_all_single(got, payload, out_splits, in_splits, group=group)
    out, at = [], 0
    for t, c in zip(tensors, cols):
        part = got[:, at:at + c.shape[1]].contiguous().view(t.dtype)
        out.append(part.reshape((got.shape[0],) + t.shape[1:]))
        at += c.shape[1]
    return out
