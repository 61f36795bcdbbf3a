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

from typing import Any, Callable, Generator, Iterable, Iterator, List, NamedTuple, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = ["Collective", "all_gather_cat", "body_of", "copy_state_", "fold_seed", "local_sample_size", "pmean_tree",
           "prefetch_staged", "replicas_equal", "run_shards", "shard_generators", "split", "stage", "state_tensors",
           "train_batches"]


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


_COLLECTIVES = {"pmean": _pmean, "gather": _gather}


def run_shards(bodies: Sequence[Generator[Collective, Any, Any]]) -> List[Any]:
    """Drive one step body per shard in lockstep: each runs to its next
    collective (in shard order), the collective is computed over all of
    them, and each resumes with its shard's result.  Returns every shard's
    return value.  The shards must reach the same collectives in the same
    order and return together."""
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
        sends = _COLLECTIVES[requests[0].op]([r.tree for r in requests])


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


def shard_generators(generator: torch.Generator, seed: int, devices: Sequence[torch.device]) -> List[torch.Generator]:
    """One random stream per shard: shard 0 draws from the run's
    ``generator`` (so one shard draws what the one-device run draws), shard
    i from a generator on its device seeded with :func:`fold_seed`."""
    return [generator] + [torch.Generator(device=d).manual_seed(fold_seed(seed, i))
                          for i, d in enumerate(devices) if i > 0]


def local_sample_size(global_batch: int) -> int:
    """Rows this process draws from its replay buffer so that the trained
    global batch is ``global_batch``: all of them, as one process drives
    every shard (the JAX function with ``process_count() == 1``, host or
    device-resident replay alike).  The loops draw through it so that the
    multi-host slice divides by the process count in one place."""
    return int(global_batch)


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
