"""The shards' layout (counterpart of ``sheeprl_tpu/parallel/mesh.py``).

The JAX package is single-controller: one process drives every local
device through a 1-D ``data`` mesh, the batch sharded over it and the
parameters replicated.  The port keeps that design in each process: a data
axis of N shards, shard i placed on ``cuda:(i mod device_count)`` (or the
CPU under ``fabric.accelerator=cpu``), each shard with a replica of its own
of the parameters and optimizer state.  With fewer devices than shards a
device holds several shards and runs them in turn; the shards still keep
one replica each, so a run on one device executes the code N devices run.
JAX refuses more shards than devices (``sheeprl_tpu/parallel/runtime.py:84``):
this placement is the port's one departure, the counterpart of the JAX
tests' ``--xla_force_host_platform_device_count``.

Over P processes (``parallel/runtime.py``) the N shards are cut into P
runs of ``n = N // P``: process p holds the global shards ``[p * n, (p +
1) * n)`` (:func:`global_shard`), its local shard i on ``cuda:(i mod
device_count)`` (the CPU under ``fabric.accelerator=cpu``), so two
processes on one card both place their shards on ``cuda:0``.

Under FSDP (``fabric.fsdp`` = k > 1) the N shards form the JAX mesh's
``(data, model)`` layout of ``(N // k, k)``: shard d sits at data row
``d // k`` and model index ``d % k`` (the JAX ``reshape(n // fsdp, fsdp)``
order, :func:`mesh_position`), and ``parallel/fsdp.py`` slices the
parameters and the optimizer state over the model axis."""

from __future__ import annotations

import copy
from typing import Any, List, Sequence

import torch
from torch import nn


def placement(n: int, accelerator: Any) -> List[torch.device]:
    """The device of each of a process's ``n`` shards, in shard order: all
    the CPU under ``accelerator=cpu``, else ``cuda:(i mod
    torch.cuda.device_count())`` by local index.  One shard keeps the
    current CUDA device (``torch.device("cuda")``)."""
    from sheeprl_tpu_torch.parallel.runtime import resolve_device

    first = resolve_device(accelerator)
    if first.type == "cpu" or n == 1:
        return [first] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def global_shard(process: int, local: int, per_process: int) -> int:
    """The global index of process ``process``'s local shard ``local``,
    each process holding ``per_process`` consecutive shards."""
    return int(process) * int(per_process) + int(local)


def shared_devices(devices: Sequence[torch.device]) -> List[str]:
    """The devices that hold more than one shard, each once."""
    names = [str(d) for d in devices]
    return sorted({d for d in names if names.count(d) > 1})


def model_axis_size(runtime: Any = None) -> int:
    """Extent of FSDP's ``model`` axis: the runtime's ``fsdp`` (1 without
    a runtime, or without FSDP)."""
    return int(getattr(runtime, "fsdp", 1) or 1)


def mesh_position(shard: int, model_axis: int) -> tuple:
    """Shard ``shard``'s ``(data row, model index)`` in the ``(N // k, k)``
    layout, ``k = model_axis``: the JAX mesh's row-major order."""
    return shard // model_axis, shard % model_axis


def _move(obj: Any, device: torch.device) -> Any:
    """``obj`` (a module, or a tuple / list / dict of them) on ``device``,
    in place."""
    if isinstance(obj, nn.Module):
        return obj.to(device)
    if isinstance(obj, dict):
        for v in obj.values():
            _move(v, device)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _move(v, device)
    return obj


def replicate(modules: Any, devices: Sequence[torch.device]) -> List[Any]:
    """One replica of ``modules`` (a module, or a tuple / list / dict of
    them) per shard: shard 0's is ``modules`` itself, every other a deep
    copy moved to its shard's device.  Shards that share a device do not
    share a replica."""
    return [modules] + [_move(copy.deepcopy(modules), device) for device in devices[1:]]


def shard_along(tree: Any, devices: Sequence[torch.device], axis: int = 0) -> List[Any]:
    """``dp.stage(tree, devices, batch_axis=axis)``: block d of every leaf
    along ``axis`` on ``devices[d]``, the layout of the JAX
    ``NamedSharding`` over the data axis (the loops call ``stage``)."""
    from sheeprl_tpu_torch.parallel.dp import stage

    return stage(tree, devices, batch_axis=axis)
