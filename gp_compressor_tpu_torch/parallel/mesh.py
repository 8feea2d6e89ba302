"""The (data x chain) device mesh, and the rows each rank owns on it.

The counterpart of `gp_compressor_tpu.parallel.mesh`. The JAX package
annotates shardings and lets XLA insert the collectives; here every rank
runs the same program on explicit shards (SPMD) and calls the collectives
itself, on the process groups of a `torch.distributed` `DeviceMesh` with
the named dims (data, chain):

  * `data`  - the patch bank's leading axis is cut into contiguous row
    blocks, one per data coordinate; every per-patch op is local, and the
    global sums (RMSE, registration's twist) are one all-reduce over the
    data group.
  * `chain` - independent MAP starts and HMC chains are cut the same way
    over the chain coordinate and all-gathered in chain order.

Tensors that are not cut are whole on every rank (replicated). No DTensor:
the front end is sorts, scatters and segment sums over points, which
DTensor does not partition, and explicit shards say which rows a rank owns.

Name for name:

  =============================  ======================================
  gp_compressor_tpu             here
  =============================  ======================================
  make_mesh(cfg, devices)        make_mesh(cfg, device_type): a DeviceMesh
                                 over the joined process group
  patch_sharding(mesh)           patch_rows(B, mesh): the slice of the
                                 patch axis this rank owns
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
  =============================  ======================================

A cut axis must divide evenly, as a JAX `NamedSharding` requires:
`pad_to_multiple` gives the size to pad to.
"""

from __future__ import annotations

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


def all_reduce_sum(t: torch.Tensor, mesh: DeviceMesh,
                   axis: str = "data") -> torch.Tensor:
    """The sum of t over the ranks along `axis`, as a new tensor: one
    collective, whatever t's size."""
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return out
