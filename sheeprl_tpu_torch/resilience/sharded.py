"""Partial-shard checkpoints for FSDP runs (counterpart of
``sheeprl_tpu/resilience/sharded.py``).

Under ``fabric.fsdp`` = k > 1 a checkpoint is a group of k files: file m
holds only the slices model shard m owns, so a shard's bytes fall with the
axis.  Which leaves are sliced, and along which dimension, is the FSDP rule
(``parallel/fsdp.py::shard_axis``) re-run on each leaf of the state tree in
the layout the port writes (flax parameters, optax states, replay), so the
JAX package's writer slices the same leaves.  Every file's manifest records
``{"world_size": k, "rank": m, "group_step": step, "partial": true,
"layout": {dotted-path: {"shape", "dtype", "axis", "parts"}}}``:

- file 0 is canonical: the whole nested tree with each sliced leaf
  replaced by its slice 0, so resume selection, the step and the tree spec
  read it as any checkpoint;
- files 1..k-1 are flat ``{dotted-path: slice}`` dicts.

:func:`load_sharded_checkpoint` walks file 0 and joins the slices along
their recorded axes into the whole host tree, which any axis size (or one
device) places anew.  A group written by either package reads in the
other."""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from sheeprl_tpu_torch.resilience.coordination import rank_shard_path
from sheeprl_tpu_torch.resilience.manifest import checkpoint_step, read_manifest, save_verified_checkpoint


def _walk(node: Any, prefix: str, leaf_fn):
    """``node`` rebuilt with every leaf passed through ``leaf_fn(dotted_path,
    leaf)``, the manifest's ``tree_spec`` path grammar (``a.b[0].c``);
    NamedTuples and the optax stand-ins keep their class."""
    from sheeprl_tpu_torch.utils.checkpoint import OptaxState

    if isinstance(node, Mapping):
        return {key: _walk(value, f"{prefix}.{key}" if prefix else str(key), leaf_fn) for key, value in node.items()}
    if isinstance(node, OptaxState):
        return type(node)(*(_walk(value, f"{prefix}[{i}]", leaf_fn) for i, value in enumerate(node.fields)))
    if isinstance(node, (list, tuple)):
        items = [_walk(value, f"{prefix}[{i}]", leaf_fn) for i, value in enumerate(node)]
        if isinstance(node, tuple):
            return type(node)(*items) if hasattr(node, "_fields") or hasattr(type(node), "qualname") else tuple(items)
        return items
    return leaf_fn(prefix, node)


def partial_group_record(axis_size: int, rank: int, step: Optional[int], layout: Mapping[str, Any]) -> Dict[str, Any]:
    return {"world_size": int(axis_size), "rank": int(rank), "group_step": step, "partial": True,
            "layout": dict(layout)}


def save_sharded_checkpoint(path: str, state: Mapping[str, Any], axis_size: int,
                            min_shard_bytes: Optional[int] = None) -> Dict[str, Any]:
    """Write ``state`` as an ``axis_size``-way partial-shard group, files
    1..k-1 first and the canonical file 0 last: a crash mid-group leaves no
    selectable file 0, or a torn group that resume skips.  Returns ``{path,
    step, shards, bytes, bytes_shard0}``."""
    from sheeprl_tpu_torch.parallel.fsdp import shard_axis
    from sheeprl_tpu_torch.utils.checkpoint import npify

    if axis_size <= 1:
        raise ValueError(f"sharded save needs axis_size > 1, got {axis_size}")
    path = str(path)
    step = checkpoint_step(path, state)
    layout: Dict[str, Dict[str, Any]] = {}
    partials: List[Dict[str, Any]] = [dict() for _ in range(axis_size - 1)]

    def slice_leaf(leaf_path: str, leaf: Any) -> Any:
        leaf = npify(leaf)
        shape, dtype = getattr(leaf, "shape", None), getattr(leaf, "dtype", None)
        if shape is None or dtype is None:
            return leaf
        axis = shard_axis(tuple(shape), dtype, axis_size, min_shard_bytes)
        if axis is None:
            return leaf
        arr = np.asarray(leaf)
        layout[leaf_path] = {"shape": list(arr.shape), "dtype": str(arr.dtype), "axis": int(axis),
                             "parts": int(axis_size)}
        pieces = np.split(arr, axis_size, axis=axis)
        for rank in range(1, axis_size):
            partials[rank - 1][leaf_path] = pieces[rank]
        return pieces[0]

    shard0 = _walk(state, "", slice_leaf)
    total = 0
    for rank in range(1, axis_size):
        total += save_verified_checkpoint(rank_shard_path(path, rank), partials[rank - 1], step=step,
                                          group=partial_group_record(axis_size, rank, step, layout))["bytes"]
    first = save_verified_checkpoint(path, shard0, step=step, group=partial_group_record(axis_size, 0, step, layout))
    return {"path": path, "step": step, "shards": axis_size, "bytes": total + first["bytes"],
            "bytes_shard0": first["bytes"]}


def partial_layout(ckpt_path: str) -> Optional[Dict[str, Any]]:
    """The layout a checkpoint's manifest group records, or None for a
    checkpoint that is not a partial shard."""
    group = (read_manifest(ckpt_path) or {}).get("group")
    if not isinstance(group, Mapping) or not group.get("partial"):
        return None
    layout = group.get("layout")
    return dict(layout) if isinstance(layout, Mapping) else {}


def is_partial_checkpoint(ckpt_path: str) -> bool:
    return partial_layout(ckpt_path) is not None


def load_sharded_checkpoint(ckpt_path: str) -> Dict[str, Any]:
    """The whole host tree of the partial-shard group whose file 0 is
    ``ckpt_path``.  The group must be complete (every file there with the
    same ``group_step``; resume selection verifies their digests): a torn
    group raises, and so does a joined leaf whose shape is not the one the
    manifest records."""
    from sheeprl_tpu_torch.resilience.coordination import group_status
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    ckpt_path = str(ckpt_path)
    group = (read_manifest(ckpt_path) or {}).get("group") or {}
    layout = partial_layout(ckpt_path)
    if layout is None:
        raise ValueError(f"'{ckpt_path}' is not a partial-shard checkpoint")
    complete, reason = group_status(ckpt_path, deep=False)
    if not complete:
        raise ValueError(f"partial-shard group for '{ckpt_path}' is torn ({reason})")
    axis_size = int(group.get("world_size", 1) or 1)
    shard0 = load_state(ckpt_path)
    siblings = [load_state(rank_shard_path(ckpt_path, rank)) for rank in range(1, axis_size)]

    def join_leaf(leaf_path: str, leaf: Any) -> Any:
        record = layout.get(leaf_path)
        if record is None:
            return leaf
        pieces = [np.asarray(leaf)]
        for flat in siblings:
            if leaf_path not in flat:
                raise KeyError(f"shard is missing slice for '{leaf_path}'")
            pieces.append(np.asarray(flat[leaf_path]))
        whole = np.concatenate(pieces, axis=int(record["axis"]))
        if list(whole.shape) != list(record["shape"]):
            raise ValueError(f"reassembled '{leaf_path}' has shape {list(whole.shape)}, manifest records "
                             f"{record['shape']}")
        return whole

    return _walk(shard0, "", join_leaf)
