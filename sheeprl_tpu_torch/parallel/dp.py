"""Coupled data parallelism over the data axis (counterpart of
``sheeprl_tpu/parallel/dp.py``).

The JAX package writes each train step for the local view and runs it
under ``shard_map``: every device takes its block of the batch, folds its
own random key, and the body ``pmean``-reduces its gradients and metrics
(and all-gathers DreamerV3's lambda values) where the collectives stand.
Here a step body is a Python generator written for the local view too;
each collective is a ``yield from`` (:func:`pmean_tree`,
:func:`all_gather_cat`) that hands its operand to :func:`run_shards`, which
drives one body per shard in lockstep on one host thread and answers every
collective with the same value on each shard:

- ``pmean``: each shard's tensors gathered to shard 0's device, summed in
  shard order there, divided by the shard count, and a copy of the mean
  sent back to each shard's device.  The copies are the same bytes, so the
  replicas, which each apply their own optimizer step to them, stay bitwise
  equal.
- ``gather``: the shards' tensors stacked on a new leading axis on shard 0's
  device, a copy to each shard.
- ``first``: shard 0's tensor, a copy to each shard (:func:`agreed`: the
  clip's norm, so that a card's float reduction, which can round the same
  reduced gradient apart from one call to the next, cannot part the
  replicas).

Under FSDP (``fabric.fsdp > 1``, ``parallel/fsdp.py``) the shards also sit
on a model axis, and between steps each shard's modules hold only their
model index's slices of the parameters the rule cuts.  A step body runs
under :func:`holding_whole`: it begins with a ``model_gather`` of those
parameters whole into the shard's modules and ends by cutting them back to
the shard's slices.  An optimizer cut by ``fsdp.shard_optimizer`` steps its
model shard's slices: :func:`reduce_gradients` answers with the mean over
all N shards, each model shard keeping its slice (``reduce_scatter``);
:func:`gradient_norm` sums the slices' squares over the model axis
(``model_sum``), so the clip and the ``Grads/*`` norms see the whole
gradient; :func:`apply_update` steps the slices and gathers the updated
ones whole again for the rest of the step (``model_gather``), which reads
them (the DreamerV3 family's behaviour learning runs on the world model
as just updated, as the JAX step's imagination reads its updated, sharded
world model).  That step is global-view, as the JAX FSDP step is: with
:func:`global_streams` every draw is the one-device step's draw on the
global batch, cut into the shards' blocks.

Over processes (``fabric.num_nodes > 1``, ``parallel/runtime.py``) each
process drives its own shards, and :func:`run_shards` answers ``pmean``,
``gather`` and ``first`` across them: every process's operands travel as host bytes
through the gloo group (one ``all_gather`` of their packed bytes a
collective), and each process then computes the collective in global shard
order on its first shard's device, exactly as one process computes it over
all the shards.  So every rank's replicas hold the same bytes, which are
the bytes of the one-process run with the same global shard count.  That
moves every operand to every process (N times a ring all-reduce's bytes);
FSDP's collectives stay within one process (``fabric.fsdp > 1`` over
processes is refused).

With one shard every collective returns its operand as it is: the one-device
step runs the same body.  The reductions are plain copies and sums, as the
JAX ``pmean`` is XLA's collective and not a Pallas kernel; they take the same
path whether the shards share a device or not.

The helpers the loops use: :func:`stage` (a batch cut into per-shard blocks
along its batch axis, block d to shard d, the JAX ``stage``'s layout),
:func:`shard_generators` (the per-shard random streams that stand for
``fold_key``), :func:`local_sample_size`, :func:`train_batches` and
:func:`prefetch_staged` (the Dreamer loops' per-gradient-step staging, the
next step's blocks copied while the current step runs), and
:func:`replicas_equal`.  ``parallel/compat.py`` has no counterpart: it
shims a JAX API that moved."""

from __future__ import annotations

from typing import Any, Callable, Generator, Iterable, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = ["Collective", "GlobalStream", "agreed", "all_gather_cat", "apply_update", "body_of", "copy_state_",
           "draw", "fold_seed", "global_streams", "gradient_norm", "holding_whole", "local_sample_size",
           "pmean_tree", "prefetch_staged", "process_count", "reduce_gradients", "replicas_equal", "run_shards",
           "shard_generators", "split", "stage", "state_tensors", "train_batches", "whole_gradients"]


class Collective(NamedTuple):
    """What a step body yields at a collective: its op and operand tree."""

    op: str
    tree: Any


def pmean_tree(tree: Any) -> Generator[Collective, Any, Any]:
    """The mean of ``tree`` (tensors in dicts, lists, tuples) over the
    shards: ``tree = yield from pmean_tree(tree)`` inside a step body."""
    return (yield Collective("pmean", tree))


def all_gather_cat(x: torch.Tensor) -> Generator[Collective, Any, torch.Tensor]:
    """Every shard's ``x`` stacked on a new leading axis, the same on every
    shard (the reference's ``fabric.all_gather``); with one shard ``x``
    itself."""
    return (yield Collective("gather", x))


def _pmean(trees: List[Any]) -> List[Any]:
    n = len(trees)
    if n == 1:
        return trees
    flat = [pytree.tree_flatten(t) for t in trees]
    spec = flat[0][1]
    leaves = [[leaf.detach() for leaf in f[0]] for f in flat]
    root = leaves[0]
    acc = torch._foreach_add(root, [leaf.to(r.device) for leaf, r in zip(leaves[1], root)])
    for other in leaves[2:]:
        torch._foreach_add_(acc, [leaf.to(r.device) for leaf, r in zip(other, root)])
    torch._foreach_div_(acc, float(n))
    out = [pytree.tree_unflatten(acc, spec)]
    for i in range(1, n):
        out.append(pytree.tree_unflatten([a.to(leaf.device, copy=True) for a, leaf in zip(acc, leaves[i])], spec))
    return out


def _gather(values: List[torch.Tensor]) -> List[torch.Tensor]:
    if len(values) == 1:
        return values
    root = values[0].device
    stacked = torch.stack([v.detach().to(root) for v in values])
    return [stacked] + [stacked.to(v.device, copy=True) for v in values[1:]]


def agreed(x: torch.Tensor) -> Generator[Collective, Any, torch.Tensor]:
    """``x`` as global shard 0 holds it, on every shard: ``x = yield from
    agreed(x)`` for a value each shard computes alike from reduced operands
    and the update then reads (a gradient's global norm, which sets the
    clip).  A card's float reduction may round the same operands apart from
    one call to the next, which would part the replicas; with one shard
    ``x`` itself."""
    return (yield Collective("first", x))


def _first(values: List[torch.Tensor]) -> List[torch.Tensor]:
    return [values[0]] + [values[0].detach().to(v.device, copy=True) for v in values[1:]]


def _model_groups(n: int, size: int) -> List[range]:
    """The shards of each data row: ``size`` consecutive shards, model
    index ``d % size`` (``parallel/mesh.py``'s layout)."""
    return [range(r, r + size) for r in range(0, n, size)]


def _reduce_scatter(trees: List[Any]) -> List[Any]:
    """Operands ``(grads, axes, size)``: the mean of the shards' gradients
    over all of them (summed in shard order on shard 0's device), and to
    each shard its model index's slice of each leaf the rule cuts
    (``axes[i]``), every other leaf whole; the slices are copies, so a
    shard keeps only its own."""
    from sheeprl_tpu_torch.parallel.fsdp import leaf_slice

    grads = [list(t[0]) for t in trees]
    axes, size = trees[0][1], trees[0][2]
    n = len(grads)
    root = [g.detach() for g in grads[0]]
    acc = [g.clone() for g in root] if n == 1 else torch._foreach_add(root, [g.to(r.device) for g, r in
                                                                             zip(grads[1], root)])
    for other in grads[2:]:
        torch._foreach_add_(acc, [g.to(r.device) for g, r in zip(other, root)])
    if n > 1:
        torch._foreach_div_(acc, float(n))
    out = []
    for d in range(n):
        index = d % size
        mine = []
        for a, axis, g in zip(acc, axes, grads[d]):
            if axis is None:
                mine.append(a if d == 0 else a.to(g.device, copy=True))
            else:
                mine.append(leaf_slice(a, axis, index, size).to(g.device, copy=True))
        out.append(mine)
    return out


def _model_sum(trees: List[Any]) -> List[torch.Tensor]:
    """Operands ``(x, size)``: the sum of ``x`` over each data row's model
    shards, in model order on the row's first device, a copy to each."""
    size = trees[0][1]
    out: List[Any] = [None] * len(trees)
    for group in _model_groups(len(trees), size):
        first = trees[group[0]][0]
        total = first.detach().clone()
        for d in group[1:]:
            total = total + trees[d][0].detach().to(first.device)
        for d in group:
            out[d] = total if d == group[0] else total.to(trees[d][0].device, copy=True)
    return out


def _model_gather(trees: List[Any]) -> List[Any]:
    """Operands ``(leaves, axes, size)``: each leaf the rule cuts joined
    from the row's model shards' slices along its axis (on the row's first
    device, a copy to each), every other leaf each shard's own."""
    axes, size = trees[0][1], trees[0][2]
    out: List[Any] = [None] * len(trees)
    for group in _model_groups(len(trees), size):
        device = trees[group[0]][0][0].device if trees[group[0]][0] else None
        joined = [None if axis is None else torch.cat([trees[d][0][i].detach().to(device) for d in group], dim=axis)
                  for i, axis in enumerate(axes)]
        for d in group:
            own = trees[d][0]
            out[d] = [own[i] if axis is None else (j if d == group[0] else j.to(own[i].device, copy=True))
                      for i, (axis, j) in enumerate(zip(axes, joined))]
    return out


_COLLECTIVES = {"pmean": _pmean, "gather": _gather, "first": _first, "reduce_scatter": _reduce_scatter,
                "model_sum": _model_sum, "model_gather": _model_gather}


def process_count() -> int:
    """The processes of the run's ``torch.distributed`` group (1 without
    one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _pack(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """The leaves' bytes on the host, one flat ``uint8`` tensor."""
    if not leaves:
        return torch.zeros(0, dtype=torch.uint8)
    return torch.cat([t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8) for t in leaves])


def _unpack(buf: torch.Tensor, like: Sequence[torch.Tensor], device: torch.device) -> List[torch.Tensor]:
    """Tensors shaped and typed as ``like`` from ``_pack``'s bytes, on
    ``device``."""
    out, offset = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[offset:offset + n].clone().view(t.dtype).reshape(t.shape).to(device))
        offset += n
    return out


def _across_processes(op: str, trees: List[Any], processes: int) -> List[Any]:
    """The collective ``op`` over every process's shards (``trees``: this
    process's operands, in local shard order): each process's operands
    gathered as host bytes, then computed in global shard order on this
    process's first shard's device, its own shards' results returned."""
    import torch.distributed as dist

    if op not in ("pmean", "gather", "first"):
        raise NotImplementedError(f"the {op!r} collective over {processes} processes is not ported "
                                  "(fabric.fsdp > 1 across processes: see ROADMAP.md Queue 1)")
    flat = [pytree.tree_flatten(t) for t in trees]
    leaves = [leaf for f in flat for leaf in f[0]]
    if not all(isinstance(leaf, torch.Tensor) for leaf in leaves):
        raise TypeError(f"a {op!r} operand over processes holds tensors only")
    mine = _pack(leaves)
    bufs = [torch.empty_like(mine) for _ in range(processes)]
    dist.all_gather(bufs, mine)
    rank, local, root = dist.get_rank(), len(trees), leaves[0].device
    global_trees: List[Any] = []
    for r, buf in enumerate(bufs):
        if r == rank:
            global_trees.extend(trees)
            continue
        remote = iter(_unpack(buf, leaves, root))
        global_trees.extend(pytree.tree_unflatten([next(remote) for _ in f[0]], f[1]) for f in flat)
    # the collective sends each shard's result to its operand's device: this
    # process's shards' own devices
    return _COLLECTIVES[op](global_trees)[rank * local:(rank + 1) * local]


def run_shards(bodies: Sequence[Generator[Collective, Any, Any]]) -> List[Any]:
    """Drive one step body per shard in lockstep: each runs to its next
    collective (in shard order), the collective is computed over all of
    them, and each resumes with its shard's result.  Returns every shard's
    return value.  The shards must reach the same collectives in the same
    order and return together; over processes every process's shards must,
    and the collectives cross them (:func:`_across_processes`)."""
    processes = process_count()
    bodies = list(bodies)
    sends: List[Any] = [None] * len(bodies)
    while True:
        requests: List[Collective] = []
        results: List[Any] = []
        for body, value in zip(bodies, sends):
            try:
                requests.append(body.send(value))
            except StopIteration as stop:
                results.append(stop.value)
        if results:
            if requests:
                raise RuntimeError(f"{len(results)} of {len(bodies)} shards returned while the others wait at "
                                   f"{requests[0].op!r}")
            return results
        ops = {r.op for r in requests}
        if len(ops) != 1:
            raise RuntimeError(f"the shards reached different collectives: {sorted(ops)}")
        op, trees = requests[0].op, [r.tree for r in requests]
        sends = _COLLECTIVES[op](trees) if processes == 1 else _across_processes(op, trees, processes)


def reduce_gradients(grads: Sequence[torch.Tensor], optimizer: Any) -> Generator[Collective, Any, List[Any]]:
    """``grads = yield from reduce_gradients(grads, optimizer)``: their mean
    over the shards (:func:`pmean_tree`); for an optimizer cut by
    ``fsdp.shard_optimizer``, this model shard's slices of the mean
    (``reduce_scatter``)."""
    from sheeprl_tpu_torch.parallel.fsdp import layout_of

    layout = layout_of(optimizer)
    if layout is None:
        return (yield from pmean_tree(list(grads)))
    return (yield Collective("reduce_scatter", (list(grads), layout.axes, layout.size)))


def gradient_norm(grads: Sequence[torch.Tensor], optimizer: Any,
                  keep: Optional[Sequence[bool]] = None) -> Generator[Collective, Any, torch.Tensor]:
    """The global norm of the reduced gradient (``optax.global_norm``), of
    the leaves ``keep`` marks (all by default), global shard 0's on every
    shard (:func:`agreed`).  Under FSDP the squares of the shard's slices are
    summed over the model axis and the whole leaves counted once, so every
    model shard holds the norm of the whole gradient."""
    from sheeprl_tpu_torch.parallel.fsdp import layout_of
    from sheeprl_tpu_torch.utils.optim import global_norm

    layout = layout_of(optimizer)
    keep = [True] * len(grads) if keep is None else list(keep)
    if layout is None:
        return (yield from agreed(global_norm([g for g, k in zip(grads, keep) if k])))
    sliced = [(g.float() ** 2).sum() for g, a, k in zip(grads, layout.axes, keep) if k and a is not None]
    whole = [(g.float() ** 2).sum() for g, a, k in zip(grads, layout.axes, keep) if k and a is None]
    part = sum(sliced) if sliced else torch.zeros((), device=grads[0].device)
    total = yield Collective("model_sum", (part, layout.size))
    return (yield from agreed(torch.sqrt(total + sum(whole)) if whole else torch.sqrt(total)))


def whole_gradients(grads: Sequence[torch.Tensor], optimizer: Any) -> Generator[Collective, Any, List[Any]]:
    """The reduced gradient whole on every shard (the health stats read it):
    the grads themselves without FSDP, the model shards' slices joined
    under it (``model_gather``)."""
    from sheeprl_tpu_torch.parallel.fsdp import layout_of

    layout = layout_of(optimizer)
    if layout is None:
        return list(grads)
    return (yield Collective("model_gather", (list(grads), layout.axes, layout.size)))


def apply_update(optimizer: Any, grads: Sequence[torch.Tensor], clip: float,
                 norm: torch.Tensor) -> Generator[Collective, Any, None]:
    """One optimizer step on the reduced ``grads`` clipped by ``norm``, the
    global norm of the whole gradient (:func:`gradient_norm`; optax's
    ``chain(clip_by_global_norm(clip), ...)``).  The optimizer steps what
    its groups hold: the parameters, or under FSDP this model shard's
    slices of them (their rests), after which the step's whole copies of
    the sliced parameters are gathered from the updated slices
    (``model_gather``) for the rest of the step; :func:`holding_whole` cuts
    them back to the slices when the step ends."""
    from sheeprl_tpu_torch.parallel.fsdp import layout_of

    views = [v for group in optimizer.param_groups for v in group["params"]]
    keep = norm < clip
    for v, g in zip(views, grads):
        v.grad = torch.where(keep, g, g / norm.to(g.dtype) * clip)
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    layout = layout_of(optimizer)
    if layout is None:
        return
    joined = yield Collective("model_gather", (views, layout.axes, layout.size))
    with torch.no_grad():
        for p, whole, axis in zip(layout.params, joined, layout.axes):
            if axis is not None:
                p.copy_(whole)


def holding_whole(body: Generator[Collective, Any, Any], params: Sequence[torch.Tensor]
                  ) -> Generator[Collective, Any, Any]:
    """``body`` (a shard's step) with ``params``, the parameters of the
    shard's modules that FSDP cuts (``fsdp.shard_params``), whole for its
    length: a ``model_gather`` of their rests at its start, each one cut
    back to its rest at its end (``fsdp.release_params``, which keeps what
    the step wrote).  Without cut parameters (one device, the data axis)
    the body itself."""
    from sheeprl_tpu_torch.parallel.fsdp import release_params, rest_of

    if not params:
        return (yield from body)
    rests = [rest_of(p) for p in params]
    joined = yield Collective("model_gather", ([r.tensor for r in rests], [r.axis for r in rests], rests[0].size))
    for p, whole in zip(params, joined):
        p.data = whole
    out = yield from body
    release_params(params)
    return out


class GlobalStream:
    """One random stream for the global batch, cut into the shards' blocks:
    handed to a shard's step body as its ``generator``.  The j-th draw of a
    step is drawn once, at the global shape, from the run's ``generator``
    (on its device) by the first shard to reach it, and each shard takes
    its block: the global rows ``(outer, shard, row)`` of a draw whose
    leading ``batch_dims`` dimensions hold ``(outer, row)`` with the
    shard's ``rows`` rows fastest (a ``[B, ...]`` scan step, the ``T * B``
    rows of the imagination laid out ``t * B + b``, a ``[T, B, ...]``
    draw).  The shards reach the same draws in the same order, so the
    blocks put together are what the one-device step draws on the global
    batch from the same generator."""

    def __init__(self, generator: torch.Generator, index: int, shards: int, rows: int, draws: List[Any]):
        self.generator, self.index, self.shards, self.rows = generator, index, shards, rows
        self._draws = draws
        self._count = 0

    def draw(self, fn: Callable, shape: Sequence[int], dtype: Any, device: Any, batch_dims: int) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        j, self._count = self._count, self._count + 1
        if j == len(self._draws):
            global_shape = shape[:batch_dims - 1] + (shape[batch_dims - 1] * self.shards,) + shape[batch_dims:]
            self._draws.append(fn(global_shape, dtype=dtype, device=self.generator.device, generator=self.generator))
        lead = int(np.prod(shape[:batch_dims]))
        if lead % self.rows:
            raise ValueError(f"a draw of {lead} rows is not laid out in blocks of the shard's {self.rows} rows")
        whole = self._draws[j]
        block = whole.reshape((lead // self.rows, self.shards, self.rows) + shape[batch_dims:])[:, self.index]
        if self.index == self.shards - 1:
            self._draws[j] = None  # every shard has its block
        return block.reshape(shape).to(device)


def global_streams(generator: torch.Generator, rows: Sequence[int]) -> List[GlobalStream]:
    """One :class:`GlobalStream` per shard over ``generator``, shard d's
    block ``rows[d]`` rows wide (the shards' blocks are equal)."""
    if len(set(rows)) != 1:
        raise ValueError(f"the shards' blocks differ in rows: {list(rows)}")
    draws: List[Any] = []
    return [GlobalStream(generator, d, len(rows), int(r), draws) for d, r in enumerate(rows)]


def draw(fn: Callable, shape: Sequence[int], generator: Any, *, dtype: Any = None, device: Any = None,
         batch_dims: int = 1) -> torch.Tensor:
    """``fn(shape, dtype=, device=, generator=)`` (``torch.rand``,
    ``torch.randn``): from a ``torch.Generator`` (or None) as it is, from a
    :class:`GlobalStream` the shard's block of the global draw, whose
    leading ``batch_dims`` dimensions hold the rows."""
    if isinstance(generator, GlobalStream):
        return generator.draw(fn, shape, dtype, device, batch_dims)
    return fn(tuple(shape), dtype=dtype, device=device, generator=generator)


def run_one(body: Generator[Collective, Any, Any]) -> Any:
    """One shard's body run to its end (every collective the identity)."""
    return run_shards([body])[0]


def body_of(step: Callable) -> Callable[..., Generator[Collective, Any, Any]]:
    """A step's body for :func:`run_shards`: its ``body`` where it has one,
    else the step itself as a body with no collective (a step wrapped as a
    plain callable, which runs one shard only)."""
    body = getattr(step, "body", None)
    if body is not None:
        return body

    def whole(*args: Any, **kwargs: Any):
        return step(*args, **kwargs)
        yield  # a generator that returns at its first resumption

    return whole


def fold_seed(seed: int, shard: int) -> int:
    """The seed of shard ``shard``'s random stream, from the run's seed (the
    counterpart of ``jax.random.fold_in(key, axis_index)``)."""
    return int(np.random.SeedSequence([int(seed), int(shard)]).generate_state(1, dtype=np.uint64)[0] >> 1)


def shard_generators(generator: torch.Generator, seed: int, devices: Sequence[torch.device],
                     offset: int = 0) -> List[torch.Generator]:
    """One random stream per shard of this process (``devices``, global
    shards ``offset, offset + 1, ...``): global shard 0 draws from the run's
    ``generator`` (so one shard draws what the one-device run draws),
    global shard g from a generator on its device seeded with
    :func:`fold_seed` of g."""
    return [generator if offset + i == 0 else torch.Generator(device=d).manual_seed(fold_seed(seed, offset + i))
            for i, d in enumerate(devices)]


def local_sample_size(global_batch: int) -> int:
    """Rows this process draws from its replay buffer so that the trained
    global batch is ``global_batch``: ``global_batch / process count`` (the
    JAX function), every row with one process (host or device-resident
    replay alike; the device ring is one process's, ``buffer.device=True``
    over processes being refused).  Raises where the count does not
    divide."""
    n = process_count()
    if int(global_batch) % n != 0:
        raise ValueError(f"global batch ({global_batch}) must be divisible by the process count ({n})")
    return int(global_batch) // n


def split(tree: Any, n: int, axis: int = 0) -> List[Any]:
    """Every leaf of ``tree`` (numpy arrays or tensors, in dicts, lists and
    tuples) cut into ``n`` equal contiguous blocks along ``axis``, in order:
    block d holds rows ``[d * B, (d + 1) * B)``."""
    if n == 1:
        return [tree]
    leaves, spec = pytree.tree_flatten(tree)
    blocks: List[List[Any]] = [[] for _ in range(n)]
    for leaf in leaves:
        size = leaf.shape[axis]
        if size % n:
            raise ValueError(f"a batch axis of {size} rows cannot be cut into {n} equal shards")
        b = size // n
        for d in range(n):
            index = (slice(None),) * axis + (slice(d * b, (d + 1) * b),)
            blocks[d].append(leaf[index])
    return [pytree.tree_unflatten(block, spec) for block in blocks]


def _put(leaf: Any, device: torch.device) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device, non_blocking=True).contiguous()
    return torch.from_numpy(np.ascontiguousarray(leaf)).to(device, non_blocking=True)


def stage(tree: Any, devices: Sequence[torch.device], batch_axis: int = 0) -> List[Any]:
    """A batch (host arrays or tensors) as one tree per shard: block d of
    every leaf along ``batch_axis`` on ``devices[d]`` (:func:`split`).  One
    shard takes the whole batch, a tensor already on its device as it is."""
    if len(devices) == 1:
        return [pytree.tree_map(lambda leaf: leaf.to(devices[0], non_blocking=True)
                                if isinstance(leaf, torch.Tensor) else _put(leaf, devices[0]), tree)]
    return [pytree.tree_map(lambda leaf, d=d: _put(leaf, d), block)
            for d, block in zip(devices, split(tree, len(devices), batch_axis))]


def prefetch_staged(samples: Iterable[Any], stage_fn: Callable[[Any], Any]) -> Iterator[Any]:
    """``stage_fn`` of each sample, the next one's staged before the
    current one is handed out: its host-to-device copies (non-blocking from
    pinned or host memory) overlap the current gradient step."""
    it = iter(samples)
    try:
        current = stage_fn(next(it))
    except StopIteration:
        return
    for sample in it:
        upcoming = stage_fn(sample)
        yield current
        current = upcoming
    yield current


def train_batches(samples: Iterable[Any], devices: Sequence[torch.device],
                  stage_one: Callable[[Any, torch.device], Any], batch_axis: int = 1) -> Iterator[List[Any]]:
    """The Dreamer loops' per-gradient-step batches: each sample (one
    gradient step's host arrays, or the device ring's tensors) cut into the
    shards' blocks along ``batch_axis`` and staged by ``stage_one(block,
    device)`` (float conversion, pixel scaling), the next step's while the
    current one runs (:func:`prefetch_staged`).  A sample that is a list
    is already the shards' blocks (the env-sharded ring's, each on its
    shard's device)."""
    n = len(devices)
    return prefetch_staged(samples, lambda sample: [
        stage_one(block, d) for block, d in zip(sample if isinstance(sample, list) else split(sample, n, batch_axis),
                                                devices)])


def state_tensors(obj: Any) -> List[torch.Tensor]:
    """Every tensor of ``obj``'s state in a fixed order: a module's
    parameters then buffers, an optimizer's state entries by parameter and
    by name (Adam's ``exp_avg``, ``exp_avg_sq``, ``step``), tensors as they
    are; dicts by key, lists and tuples in order."""
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, torch.optim.Optimizer):
        out: List[torch.Tensor] = []
        for group in obj.param_groups:
            for p in group["params"]:
                out.extend(v for _, v in sorted(obj.state.get(p, {}).items()) if isinstance(v, torch.Tensor))
        return out
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for k in sorted(obj) for t in state_tensors(obj[k])]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in state_tensors(v)]
    return []


def replicas_equal(replicas: Sequence[Any]) -> bool:
    """Whether every replica (modules, optimizers, tensors, in dicts, lists
    and tuples) holds the same bytes as shard 0's: parameters, buffers and
    optimizer state, compared on the host."""
    def as_bytes(t: torch.Tensor) -> torch.Tensor:
        return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)

    first = state_tensors(replicas[0])
    for other in replicas[1:]:
        tensors = state_tensors(other)
        if len(tensors) != len(first):
            return False
        for a, b in zip(first, tensors):
            if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(as_bytes(a), as_bytes(b)):
                return False
    return True


@torch.no_grad()
def copy_state_(dst: Any, src: Any) -> None:
    """``src``'s state (modules, optimizers, tensors, as :func:`state_tensors`
    orders them) copied into ``dst``'s tensors in place, bitwise, across
    devices if they differ: the decoupled loops' trainer-to-player hand-off
    and their rollback to a host copy."""
    targets, sources = state_tensors(dst), state_tensors(src)
    if len(targets) != len(sources):
        raise ValueError(f"cannot copy a state of {len(sources)} tensors into one of {len(targets)}")
    for t, s in zip(targets, sources):
        if t.shape != s.shape or t.dtype != s.dtype:
            raise ValueError(f"cannot copy a {s.dtype} {tuple(s.shape)} tensor into a {t.dtype} {tuple(t.shape)} one")
    torch._foreach_copy_(targets, sources)
