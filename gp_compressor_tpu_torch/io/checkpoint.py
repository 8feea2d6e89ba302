"""Checkpoint / resume for framework state.

The reference has no checkpointing for the GP pipeline (its
save_compressed ignores the filename, src/gp_compressor.cpp:21-27). Here a
tree of torch tensors (NamedTuples such as SOGPState banks,
CompressedCloud and MapState, tuples, lists, dicts, None) serializes to one
`.npz` in the layout of `gp_compressor_tpu.io.checkpoint`: `leaf_<i>` per
leaf in flattening order, `__treedef__` the tree structure as the string
JAX's `str(treedef)` gives (a NamedTuple is
`CustomNode(namedtuple[Name], [...])`, its fields in order; dict keys
sorted; None an empty subtree), and `__meta__` a JSON dict. So a JAX
checkpoint loads here and one written here loads in JAX, both under
`strict=True`, when the two trees have the same NamedTuple names and
fields (the port's keep JAX's).

JAX saves a typed PRNG key leaf as its uint32 key data; here it loads into
whatever tensor leaf the template has at that place (of the key data's
shape). The port's samplers draw from `torch.Generator`s, so no tree of the
port holds a key.
"""

from __future__ import annotations

import json
from typing import Any, List

import numpy as np
import torch


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _flatten(tree, leaves: List) -> str:
    """Append the leaves of `tree` to `leaves` in JAX's order; return the
    structure in JAX's treedef notation."""
    if tree is None:
        return "None"
    if _is_namedtuple(tree):
        inner = ", ".join(_flatten(c, leaves) for c in tree)
        return f"CustomNode(namedtuple[{type(tree).__name__}], [{inner}])"
    if isinstance(tree, tuple):
        parts = [_flatten(c, leaves) for c in tree]
        return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"
    if isinstance(tree, list):
        return "[" + ", ".join(_flatten(c, leaves) for c in tree) + "]"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}"
                               for k in sorted(tree)) + "}"
    leaves.append(tree)
    return "*"


def _unflatten(like, it):
    if like is None:
        return None
    if _is_namedtuple(like):
        return type(like)(*[_unflatten(c, it) for c in like])
    if isinstance(like, tuple):
        return tuple(_unflatten(c, it) for c in like)
    if isinstance(like, list):
        return [_unflatten(c, it) for c in like]
    if isinstance(like, dict):
        return {k: _unflatten(like[k], it) for k in sorted(like)}
    return next(it)


def _leaf_to_np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save(path: str, tree: Any, meta: dict | None = None) -> None:
    leaves: List = []
    structure = f"PyTreeDef({_flatten(tree, leaves)})"
    arrays = {f"leaf_{i}": _leaf_to_np(v) for i, v in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(structure.encode(), dtype=np.uint8)
    if meta:
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                           dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load(path: str, like: Any, strict: bool = True) -> Any:
    """Restore into the structure of `like`.

    Each leaf comes back as a tensor on the template leaf's device and of
    its dtype (a template leaf that is not a tensor gives a CPU tensor of
    the stored dtype). strict=True (the default) raises ValueError when
    the stored treedef or a leaf shape differs from `like`'s; strict=False
    skips both (a container renamed, the leaf layout unchanged). A leaf
    count that differs raises either way."""
    with np.load(path) as data:
        flat_like: List = []
        structure = f"PyTreeDef({_flatten(like, flat_like)})"
        if strict and "__treedef__" in data:
            stored = bytes(data["__treedef__"]).decode()
            if stored != structure:
                raise ValueError(
                    f"checkpoint treedef mismatch:\n  stored: {stored}\n"
                    f"  expected: {structure}")
        n_stored = sum(1 for k in data.files if k.startswith("leaf_"))
        if n_stored != len(flat_like):
            raise ValueError(f"checkpoint has {n_stored} leaves, template "
                             f"has {len(flat_like)}")
        leaves = []
        for i, ref in enumerate(flat_like):
            a = data[f"leaf_{i}"]
            if strict and tuple(a.shape) != tuple(np.shape(ref)):
                raise ValueError(f"checkpoint leaf {i} shape {a.shape} != "
                                 f"template {tuple(np.shape(ref))}")
            t = torch.from_numpy(np.array(a))
            if isinstance(ref, torch.Tensor):
                t = t.to(device=ref.device, dtype=ref.dtype)
            leaves.append(t)
    return _unflatten(like, iter(leaves))


def load_meta(path: str) -> dict:
    with np.load(path) as data:
        if "__meta__" in data:
            return json.loads(bytes(data["__meta__"]).decode())
    return {}
