"""FSDP over the ``("data", "model")`` layout of the shards (counterpart of
``sheeprl_tpu/parallel/fsdp.py``).

The partition rule is the JAX package's, and deterministic on ``(shape,
dtype)`` alone (:func:`shard_axis`): a leaf under ``min_shard_bytes`` is
replicated; otherwise its largest dimension divisible by the model axis's
extent is cut over the model axis (ties go to the leading axis), and a leaf
with no divisible dimension stays replicated.  The train step, the memory
audit and the checkpoint writer (``resilience/sharded.py``) all call it, so
they never disagree about a leaf.

The port's placement (one process drives the N shards, ``parallel/dp.py``):
shard d sits at ``(d // fsdp, d % fsdp)`` of the ``(N // fsdp, fsdp)``
layout (``parallel/mesh.py``).  Between steps each shard's modules hold,
of every parameter the rule cuts, only its model index's slice (ZeRO-3, the
JAX ``shard_tree`` placement): :func:`shard_params` gives each such
parameter its *rest*, a slice of its own storage, and
:func:`release_params` makes the parameter hold it.  A step gathers them
whole for its length (``parallel/dp.py::holding_whole``: a ``model_gather``
at its start, the rests cut again from the whole at its end), as the JAX
step's forward is global-view; the player and a checkpoint read them whole
through :func:`whole_params`, a transient join of the model shards' rests.
Each shard's optimizer is :func:`shard_optimizer`'s: the same optimizer
over the rests (the whole leaves themselves), its state (Adam's moments)
held sliced; the step counter and the leaves the rule replicates stay
whole.  In memory a slice is cut from the torch leaf (``Linear`` ``[out,
in]``, ``Conv`` OIHW): the set of divisible dimensions is the flax
layout's, so the counts and the per-shard bytes are the JAX summary's
(:func:`tree_bytes_per_device`).  A checkpoint joins the rests on the host
(:func:`whole_params` onto the CPU, :func:`gathered_optimizers`) into the
tree the port writes, and the sharded writer slices that tree in its flax
layout, as the JAX writer slices its own."""

from __future__ import annotations

import collections
import contextlib
import copy
from typing import Any, Dict, Iterator, List, Mapping, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np

# Below this, a leaf is cheaper to replicate than to gather: biases, layer
# norms, scalar moments.  ``fabric.fsdp_min_shard_bytes`` overrides it.
DEFAULT_MIN_SHARD_BYTES = 65536


def fsdp_active(axis_size: Optional[int]) -> bool:
    """Whether a model axis of ``axis_size`` shards anything (extent > 1)."""
    return int(axis_size or 1) > 1


def _itemsize(dtype: Any) -> int:
    size = getattr(dtype, "itemsize", None)  # numpy and torch dtypes
    return int(size) if isinstance(size, int) else np.dtype(dtype).itemsize


def shard_axis(shape: Tuple[int, ...], dtype: Any, axis_size: int,
               min_shard_bytes: Optional[int] = None) -> Optional[int]:
    """The dimension the rule cuts over the model axis, or None (replicated):
    a pure function of ``(shape, dtype, axis_size, min_shard_bytes)``, the
    JAX package's.  ``dtype`` is a numpy or torch dtype."""
    if min_shard_bytes is None:
        min_shard_bytes = DEFAULT_MIN_SHARD_BYTES
    if axis_size <= 1 or not shape:
        return None
    nbytes = int(np.prod(shape)) * _itemsize(dtype)
    if nbytes < min_shard_bytes:
        return None
    best = None
    for i, dim in enumerate(shape):
        if dim >= axis_size and dim % axis_size == 0:
            if best is None or dim > shape[best]:
                best = i
    return best


def leaf_slice(leaf: Any, axis: int, index: int, size: int) -> Any:
    """Model shard ``index``'s slice of the tensor ``leaf`` along ``axis``,
    of ``size`` equal slices: a view."""
    step = leaf.shape[axis] // size
    return leaf.narrow(axis, index * step, step)


def _leaves(node: Any) -> Iterator[Any]:
    """The array leaves of a checkpoint-layout tree, in the JAX
    ``tree_leaves`` order: dicts by key, lists and tuples (optax states by
    their fields) in order; None is no leaf."""
    from sheeprl_tpu_torch.utils.checkpoint import OptaxState

    if node is None:
        return
    if isinstance(node, Mapping):
        for key in sorted(node):
            yield from _leaves(node[key])
        return
    if isinstance(node, OptaxState):
        node = node.fields
    if isinstance(node, (list, tuple)):
        for value in node:
            yield from _leaves(value)
        return
    yield node


def _leaf_bytes(leaf: Any, axis_size: int, min_shard_bytes: Optional[int]) -> Tuple[int, int]:
    """A leaf's bytes, and one model shard's bytes of it under the rule."""
    shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
    dtype = getattr(leaf, "dtype", None)
    if dtype is None or not (hasattr(dtype, "itemsize") or isinstance(dtype, np.dtype)):
        dtype = np.asarray(leaf).dtype
    nbytes = int(np.prod(shape, dtype=np.int64)) * _itemsize(dtype)
    return nbytes, nbytes if shard_axis(shape, dtype, axis_size, min_shard_bytes) is None else nbytes // axis_size


def tree_bytes_per_device(tree: Any, axis_size: int, min_shard_bytes: Optional[int] = None) -> int:
    """Bytes one model shard holds of ``tree`` (a checkpoint-layout tree of
    arrays or tensors) under the rule: a leaf the rule cuts at its slice's
    size, every other leaf whole.  The JAX function reads the leaves'
    placements; this one the rule that placed them."""
    return sum(_leaf_bytes(leaf, axis_size, min_shard_bytes)[1] for leaf in _leaves(tree))


def shard_map_summary(trees: Mapping[str, Any], axis_size: int,
                      min_shard_bytes: Optional[int] = None) -> Dict[str, Any]:
    """How the rule lays out the named trees (the ``fsdp_shard_map``
    event's payload, the JAX summary's keys): per tree its leaves, how many
    are sharded and replicated, its bytes and one model shard's bytes."""
    out: Dict[str, Any] = {
        "axis_size": int(axis_size),
        "min_shard_bytes": int(DEFAULT_MIN_SHARD_BYTES if min_shard_bytes is None else min_shard_bytes),
        "trees": {},
    }
    for name, tree in trees.items():
        sizes = [_leaf_bytes(leaf, axis_size, min_shard_bytes) for leaf in _leaves(tree)]
        sharded = sum(whole != mine for whole, mine in sizes)
        out["trees"][name] = {"leaves": len(sizes), "sharded": sharded, "replicated": len(sizes) - sharded,
                              "bytes": sum(whole for whole, _ in sizes),
                              "bytes_per_device": sum(mine for _, mine in sizes)}
    return out


class Layout(NamedTuple):
    """A sliced optimizer's place on the model axis (``optimizer.fsdp``):
    the module parameters it trains (what the step differentiates, whole
    for the step), each one's rule axis (None: whole on every shard), this
    shard's model index, the axis's extent, and the optimizer it was cut
    from (which keeps no state: :func:`gathered_optimizers` fills it for a
    checkpoint)."""

    params: List[Any]
    axes: List[Optional[int]]
    index: int
    size: int
    template: Any


class Rest(NamedTuple):
    """What a cut parameter holds between steps: model shard ``index``'s
    slice of it along ``axis`` (of ``size``), a tensor of its own that the
    shard's optimizer steps."""

    tensor: Any
    axis: int
    index: int
    size: int


_rests: Any = None  # parameter -> Rest, by identity (torch's WeakIdKeyDictionary, made at first use)


def _registry() -> Any:
    global _rests
    if _rests is None:
        from torch.utils.weak import WeakIdKeyDictionary

        _rests = WeakIdKeyDictionary()
    return _rests


def rest_of(param: Any) -> Optional[Rest]:
    """The :class:`Rest` of a parameter :func:`shard_params` cut, else None."""
    return _registry().get(param)


def shard_params(params: Sequence[Any], index: int, size: int, min_shard_bytes: Optional[int] = None) -> List[Any]:
    """The parameters of ``params`` (whole at the call) that the rule cuts,
    each once, in order: each given its :class:`Rest`, a copy of model
    shard ``index``'s slice.  They stay whole until :func:`release_params`;
    a parameter cut before keeps its rest."""
    registry, out, seen = _registry(), [], set()
    for p in params:
        if id(p) in seen:
            continue
        seen.add(id(p))
        if p in registry:
            out.append(p)
            continue
        axis = shard_axis(tuple(p.shape), p.dtype, size, min_shard_bytes)
        if axis is not None:
            registry[p] = Rest(leaf_slice(p.detach(), axis, index, size).clone(), axis, index, size)
            out.append(p)
    return out


def release_params(params: Sequence[Any]) -> None:
    """Each cut parameter holds its rest again: the rest is first cut from
    what the parameter holds whole (the step's updates, a Polyak or EMA
    target's included), then the parameter's data becomes it."""
    import torch

    registry = _registry()
    with torch.no_grad():
        for p in params:
            rest = registry[p]
            if p.shape != rest.tensor.shape:
                rest.tensor.copy_(leaf_slice(p.detach(), rest.axis, rest.index, rest.size))
            p.data = rest.tensor


@contextlib.contextmanager
def whole_params(row: Sequence[Sequence[Any]], device: Any = None) -> Iterator[None]:
    """The first model shard's cut parameters (``row[0]``) whole for the
    block, joined from the model shards' rests (``row[m]``: model shard m's
    cut parameters, in the same order) on ``device`` (each parameter's own
    by default): the player's transient gather, and onto the CPU a
    checkpoint's.  They hold their rests again after it."""
    import torch

    first = list(row[0]) if row else []
    registry = _registry()
    with torch.no_grad():
        for i, p in enumerate(first):
            rest = registry[p]
            target = rest.tensor.device if device is None else torch.device(device)
            p.data = torch.cat([registry[shard[i]].tensor.to(target) for shard in row], dim=rest.axis)
    try:
        yield
    finally:
        for p in first:
            p.data = registry[p].tensor


def layout_of(optimizer: Any) -> Optional[Layout]:
    """The optimizer's :class:`Layout`, or None for a whole one."""
    return getattr(optimizer, "fsdp", None)


def shard_optimizer(optimizer: Any, index: int, size: int, min_shard_bytes: Optional[int] = None) -> Any:
    """``optimizer`` cut for model shard ``index`` of ``size``: an optimizer
    of its class and options over each parameter's rest (:func:`shard_params`;
    a leaf the rule keeps whole, the parameter itself), its state sliced the
    same way (entries of the parameter's shape; the step counter whole).
    Call it while the parameters are whole.  A step on the rests updates
    this shard's slices; the step body gathers the rest
    (``parallel/dp.py::apply_update``).  The whole optimizer gives up its
    state and becomes the layout's template."""
    import torch

    params: List[torch.Tensor] = []
    axes: List[Optional[int]] = []
    groups = []
    for group in optimizer.param_groups:
        shard_params(group["params"], index, size, min_shard_bytes)
        views = []
        for p in group["params"]:
            rest = rest_of(p)
            params.append(p)
            axes.append(None if rest is None else rest.axis)
            views.append(p.detach() if rest is None else rest.tensor)
        groups.append({**{k: v for k, v in group.items() if k != "params"}, "params": views})
    # a shallow copy keeps the class's own attributes and hooks; the groups
    # and the state are the slices'
    sliced = copy.copy(optimizer)
    sliced.param_groups = groups
    sliced.state = collections.defaultdict(dict)
    views = [v for group in sliced.param_groups for v in group["params"]]
    for p, view, axis in zip(params, views, axes):
        for key, value in optimizer.state.get(p, {}).items():
            if isinstance(value, torch.Tensor):
                value = (leaf_slice(value, axis, index, size) if axis is not None and value.shape == p.shape
                         else value).clone()
            sliced.state[view][key] = value
    optimizer.state.clear()
    sliced.fsdp = Layout(params, axes, index, size, optimizer)
    return sliced


def shard_replicas(replicas: Sequence[Any], optimizer_sets: Sequence[Mapping[str, Any]], size: int,
                   min_shard_bytes: Optional[int] = None) -> Tuple[List[Dict[str, Any]], List[List[Any]]]:
    """Every shard's state placed by the rule over a model axis of ``size``:
    shard d's modules (``replicas[d]``, an iterable of modules, whole at the
    call) left holding model index ``d % size``'s slices of the parameters
    the rule cuts (:func:`shard_params`, :func:`release_params`) and its
    optimizers (``optimizer_sets[d]``, by name, loaded) cut for that index
    (:func:`shard_optimizer`).  Returns the cut optimizers and each shard's
    cut parameters (what ``parallel/dp.py::holding_whole`` gathers for a
    step and :func:`whole_params` joins)."""
    sliced, cut = [], []
    for d, (replica, opts) in enumerate(zip(replicas, optimizer_sets)):
        cut.append(shard_params([p for m in replica for p in m.parameters()], d % size, size, min_shard_bytes))
        sliced.append({name: shard_optimizer(opt, d % size, size, min_shard_bytes) for name, opt in opts.items()})
        release_params(cut[-1])
    return sliced, cut


def _rows(optimizer_sets: Sequence[Mapping[str, Any]]) -> List[Mapping[str, Any]]:
    """The model shards of data row 0 (shards ``0..fsdp-1``)."""
    layout = layout_of(next(iter(optimizer_sets[0].values()), None))
    return list(optimizer_sets[:layout.size]) if layout is not None else list(optimizer_sets[:1])


@contextlib.contextmanager
def gathered_optimizers(optimizer_sets: Sequence[Mapping[str, Any]]) -> Iterator[Dict[str, Any]]:
    """Shard 0's optimizers, each whole: without FSDP the optimizers
    themselves; under it each layout's template, its state the model
    shards' slices joined on the host (a checkpoint's ``optax_state`` reads
    it), emptied again when the block ends."""
    row = _rows(optimizer_sets)
    if layout_of(next(iter(row[0].values()), None)) is None:
        yield dict(row[0])
        return
    import torch

    templates = {}
    for name, opt in row[0].items():
        layout = layout_of(opt)
        views = [[v for group in shard[name].param_groups for v in group["params"]] for shard in row]
        for i, (p, axis) in enumerate(zip(layout.params, layout.axes)):
            entry = row[0][name].state.get(views[0][i], {})
            whole = {}
            for key, value in entry.items():
                if isinstance(value, torch.Tensor):
                    if axis is not None and value.shape == views[0][i].shape:
                        value = torch.cat([shard[name].state[v[i]][key].detach().cpu()
                                           for shard, v in zip(row, views)], dim=axis)
                    else:
                        value = value.detach().cpu().clone()
                whole[key] = value
            if whole:
                layout.template.state[p] = whole
        templates[name] = layout.template
    try:
        yield templates
    finally:
        for template in templates.values():
            template.state.clear()


def sliced_state_ids(objs: Any) -> Set[int]:
    """The ``id`` of every tensor that is a model shard's slice (``objs``:
    modules and optimizers, in dicts, lists and tuples): the cut parameters
    the modules hold at rest, and the optimizer state of the cut leaves."""
    out: Set[int] = set()
    if isinstance(objs, Mapping):
        objs = list(objs.values())
    if not isinstance(objs, (list, tuple)):
        objs = [objs]
    registry = _registry()
    for obj in objs:
        if isinstance(obj, (Mapping, list, tuple)):
            out |= sliced_state_ids(obj)
            continue
        if hasattr(obj, "parameters") and not hasattr(obj, "param_groups"):
            out |= {id(p) for p in obj.parameters() if p in registry and p.shape == registry[p].tensor.shape}
            continue
        layout = layout_of(obj)
        if layout is None:
            continue
        views = [v for group in obj.param_groups for v in group["params"]]
        for view, axis in zip(views, layout.axes):
            if axis is not None:
                out |= {id(t) for t in obj.state.get(view, {}).values()
                        if hasattr(t, "shape") and t.shape == view.shape}
    return out


def sliced_state_equal(optimizer_sets: Sequence[Mapping[str, Any]]) -> bool:
    """Whether the shards' sliced optimizers agree: every data row's model
    shard m holds row 0's model shard m's bytes, and the whole leaves' state
    is the same on every model shard (so the gathered state of each row is
    row 0's)."""
    from sheeprl_tpu_torch.parallel.dp import replicas_equal

    size = len(_rows(optimizer_sets))
    for m in range(size):
        if not replicas_equal([list(opts.values()) for opts in optimizer_sets[m::size]]):
            return False
    for name in optimizer_sets[0]:
        whole = []
        for opts in optimizer_sets[:size]:
            opt = opts[name]
            views = [v for group in opt.param_groups for v in group["params"]]
            whole.append([t for view, axis in zip(views, layout_of(opt).axes) if axis is None
                          for _, t in sorted(opt.state.get(view, {}).items()) if hasattr(t, "shape")])
        if not replicas_equal(whole):
            return False
    return True
