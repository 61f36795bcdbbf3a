"""The ``Runtime`` (counterpart of ``sheeprl_tpu/parallel/runtime.py``):
the data axis of ``fabric.devices`` shards and, with ``fabric.fsdp`` = k >
1, their ``(data, model)`` layout of ``(N // k, k)`` (``parallel/mesh.py``,
``parallel/fsdp.py``), the processes that hold them, the precision policy
(``param_dtype``, ``compute_dtype``, the dtypes the run trains in:
``64-true`` trains in float32, as the JAX package does; see
``parallel/precision.py``), the seeding, checkpoint save/load and the
callback hooks.

One process drives every shard it holds, as the JAX package's controller
drives its host's devices.  A run is multi-process once the default
``torch.distributed`` group is initialized: by the caller, or here with
the gloo backend from torchrun's variables (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) when ``fabric.num_nodes > 1``
(without them the run is one process, with a warning, as the JAX runtime
runs without ``JAX_COORDINATOR_ADDRESS``; a failed rendezvous raises).
``fabric.devices`` then counts the shards of every process (``auto``:
every process's devices), the process count divides them, and process p
holds shards ``[p * n, (p + 1) * n)``: ``devices`` lists this process's in
shard order, ``device`` is its first (the player's), ``shard_offset`` the
global index of that first shard, ``world_size`` the global shard count.
``all_gather`` stacks every process's tree, ``broadcast`` ships a pickled
object from one rank, ``barrier`` waits for the group; with one process
they are identities.  ``save`` writes the state it is given (the loops
pass shard 0's replica, with the optimizer state gathered under FSDP) as
one file with its manifest, through the diagnostics' resilience layer when
it is open (``diagnostics``, attached by ``cli.run_algorithm``); over
processes as a coordinated group of one file a rank
(``resilience/coordination.py::coordinated_save``); under FSDP as a
partial-shard group of k files, synchronously, as the JAX runtime writes
it (``resilience/sharded.py``).  ``load`` returns one tree (a partial
group reassembled, a non-zero rank's own file of a coordinated group),
which the loops place, so a checkpoint crosses between shard counts, axis
sizes, process counts and packages.  FSDP over more than one process is
refused, naming its ROADMAP item."""

from __future__ import annotations

import datetime
import os
import pickle
import random
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.parallel.mesh import global_shard, mesh_position, placement, shared_devices
from sheeprl_tpu_torch.parallel.precision import resolve_precision, training_dtypes

_NOT_PORTED = "is not ported yet: see ROADMAP.md Queue 1"


def resolve_device(accelerator: Any) -> torch.device:
    """``cpu`` runs on the CPU; anything else means CUDA, and then a missing
    CUDA device is an error, not a reason to fall back.  TF32 stays off on
    the card: a trained or served policy should act in true fp32 (PyTorch's
    default keeps matmuls in fp32; convolutions default to TF32 through
    cuDNN)."""
    if str(accelerator) == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"fabric.accelerator={accelerator!r} selects a CUDA device and none is available; "
            "pass fabric.accelerator=cpu to run on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def shard_count(devices: Any, accelerator: Any, processes: int = 1) -> int:
    """``fabric.devices`` as a shard count over every process: ``auto`` /
    ``-1`` mean every device the accelerator has (one on the CPU) in each
    of the ``processes``."""
    if str(devices) in ("auto", "-1"):
        return (1 if str(accelerator) == "cpu" else max(1, torch.cuda.device_count())) * int(processes)
    n = int(devices)
    if n < 1:
        raise ValueError(f"fabric.devices must be a positive count, 'auto' or -1, got {devices!r}")
    return n


#: torchrun's variables, from which a run of ``fabric.num_nodes > 1`` joins its group
TORCHRUN_VARIABLES = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
#: how long a rank waits for the others at the rendezvous before it raises
RENDEZVOUS_TIMEOUT_S = 300


def _group_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def processes_for(num_nodes: Any = 1) -> int:
    """The processes a run of ``fabric.num_nodes`` takes part in: the
    initialized group's size, else ``WORLD_SIZE`` where ``num_nodes > 1``
    and torchrun's variables are set, else 1 (what the runtime will join,
    known before it is built: ``cli.check_configs`` refuses by it)."""
    import torch.distributed as dist

    if _group_initialized():
        return dist.get_world_size()
    if int(num_nodes or 1) > 1 and all(os.environ.get(k) for k in TORCHRUN_VARIABLES):
        return int(os.environ["WORLD_SIZE"])
    return 1


def join_processes(num_nodes: Any = 1) -> tuple:
    """``(process count, rank)`` of this process: the initialized group's;
    with ``num_nodes > 1`` and torchrun's variables, the gloo group joined
    here from them (a rendezvous that fails raises, the run never goes on
    alone); else one process, with a warning where ``num_nodes > 1``."""
    import torch.distributed as dist

    if not _group_initialized() and int(num_nodes or 1) > 1:
        if all(os.environ.get(k) for k in TORCHRUN_VARIABLES):
            dist.init_process_group("gloo", init_method="env://",
                                    timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
        else:
            warnings.warn(
                f"fabric.num_nodes={num_nodes} without torchrun's variables ({', '.join(TORCHRUN_VARIABLES)}): "
                "the run is one process",
                UserWarning,
            )
    if _group_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Runtime:
    """Built from ``cfg.fabric`` by ``instantiate``."""

    def __init__(
        self,
        devices: int | str = 1,
        num_nodes: int = 1,
        strategy: str = "auto",
        accelerator: str = "auto",
        precision: str = "32-true",
        callbacks: Optional[Sequence[Any]] = None,
        fsdp: int = 1,
        fsdp_min_shard_bytes: Optional[int] = None,
    ):
        del strategy
        self.param_dtype, self.compute_dtype = training_dtypes(precision)
        if resolve_precision(precision)[1] == torch.float64:
            warnings.warn(
                f"fabric.precision={precision!r} requests float64; the run trains in float32, as the JAX package "
                "does without jax_enable_x64 (its float64 casts truncate to float32)",
                UserWarning,
            )
        self.fsdp = int(fsdp or 1)
        self.fsdp_min_shard_bytes = None if fsdp_min_shard_bytes is None else int(fsdp_min_shard_bytes)
        self.process_count, self.global_rank = join_processes(num_nodes)
        if self.fsdp > 1 and self.process_count > 1:
            raise NotImplementedError(
                f"fabric.fsdp={self.fsdp} over {self.process_count} processes: FSDP across processes "
                f"{_NOT_PORTED}, Parallel: FSDP across processes"
            )
        n = shard_count(devices, accelerator, self.process_count)
        if n % self.fsdp != 0:
            raise ValueError(f"fsdp axis size ({self.fsdp}) must divide the device count ({n})")
        if n % self.process_count != 0:
            raise ValueError(f"the process count ({self.process_count}) must divide the shard count "
                             f"(fabric.devices={n})")
        local = n // self.process_count
        self._world_size = n
        self.shard_offset = global_shard(self.global_rank, 0, local)
        self.devices = placement(local, accelerator)
        self.device = self.devices[0]
        self.callbacks = list(callbacks or [])
        self.diagnostics = None
        if self.world_size > 1:
            where = ", ".join(f"shard {self.shard_offset + i} -> {d}" for i, d in enumerate(self.devices))
            if self.process_count > 1:
                where = f"rank {self.global_rank} of {self.process_count}: {where}"
            print(f"[data axis] {self.world_size} shards: {where}", flush=True)
            if self.fsdp > 1:
                print(f"[fsdp] (data, model) = ({self.world_size // self.fsdp}, {self.fsdp}): "
                      + ", ".join(f"shard {i} at {mesh_position(i, self.fsdp)}" for i in range(self.world_size)),
                      flush=True)
            shared = shared_devices(self.devices)
            if shared:
                warnings.warn(
                    f"fabric.devices={self.world_size}: {', '.join(shared)} holds more than one shard; its shards "
                    "run in turn, each with its own replica (the JAX runtime refuses more shards than devices)",
                    UserWarning,
                )

    @property
    def world_size(self) -> int:
        """The shard count over every process."""
        return self._world_size

    @property
    def is_global_zero(self) -> bool:
        return self.global_rank == 0

    def all_gather(self, tree: Any) -> Any:
        """Every process's ``tree`` (tensors, arrays, numbers, in dicts,
        lists and tuples), each leaf stacked on a new leading axis in rank
        order (the JAX ``process_allgather``); with one process the tree
        itself."""
        if self.process_count == 1:
            return tree
        import torch.distributed as dist
        from torch.utils import _pytree as pytree

        gathered: List[Any] = [None] * self.process_count
        dist.all_gather_object(gathered, tree)

        def stack(*leaves: Any) -> Any:
            if isinstance(leaves[0], torch.Tensor):
                return torch.stack([t.to(leaves[0].device) for t in leaves])
            return np.stack([np.asarray(v) for v in leaves])

        return pytree.tree_map(stack, gathered[0], *gathered[1:])

    def broadcast(self, obj: Any, src: int = 0) -> Any:
        """``obj`` as rank ``src`` holds it, on every rank: its pickle
        shipped as length-prefixed bytes over the group (the JAX runtime's
        object broadcast); with one process ``obj`` itself."""
        if self.process_count == 1:
            return obj
        import torch.distributed as dist

        payload = pickle.dumps(obj) if self.global_rank == src else b""
        size = torch.tensor([len(payload)], dtype=torch.int64)
        dist.broadcast(size, src=src)
        buf = (torch.frombuffer(bytearray(payload), dtype=torch.uint8) if self.global_rank == src
               else torch.empty(int(size.item()), dtype=torch.uint8))
        dist.broadcast(buf, src=src)
        return pickle.loads(buf.numpy().tobytes())

    def barrier(self) -> None:
        """Wait for every process of the group (nothing with one)."""
        if self.process_count > 1:
            import torch.distributed as dist

            dist.barrier()

    def seed_everything(self, seed: int) -> torch.Generator:
        """Seed Python, numpy and torch; returns the run's generator on the
        device, from which every draw of the training loop comes."""
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def launch(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        return fn(self, *args, **kwargs)

    def call(self, hook_name: str, **kwargs: Any) -> None:
        for cb in self.callbacks:
            hook = getattr(cb, hook_name, None)
            if hook is not None:
                hook(runtime=self, **kwargs)

    def save(self, path: str, state: Dict[str, Any]) -> None:
        """Checkpoint write with its manifest: through the diagnostics'
        resilience layer (async writer or blocking, journaled) when it is
        open, else a blocking save that writes the manifest all the same.
        Over processes a coordinated group, one ``ckpt_<step>_<rank>.ckpt``
        a rank (``resilience/coordination.py::coordinated_save``).  Under
        FSDP a partial-shard group (``ckpt_<step>_<k>.ckpt``, one a model
        shard, each holding the slices the rule gives it, shard 0 written
        last), synchronously, as the JAX runtime writes it."""
        if self.process_count > 1:
            from sheeprl_tpu_torch.resilience.coordination import coordinated_save

            coordinated_save(self, path, state)
            return
        if self.fsdp > 1:
            from sheeprl_tpu_torch.resilience.sharded import save_sharded_checkpoint

            save_sharded_checkpoint(path, state, axis_size=self.fsdp, min_shard_bytes=self.fsdp_min_shard_bytes)
            return
        routed = self.diagnostics is not None and self.diagnostics.save_checkpoint(path, state)
        if not routed:
            from sheeprl_tpu_torch.resilience.manifest import save_verified_checkpoint

            save_verified_checkpoint(path, state)

    def load(self, path: str) -> Dict[str, Any]:
        """A checkpoint's tree; a partial-shard group (the port's or the JAX
        package's) reassembled whole, whatever this run's axis size.  A
        non-zero rank reads its own file of a coordinated group where it
        exists (the JAX runtime's), else the rank-0 file."""
        from sheeprl_tpu_torch.resilience.coordination import rank_shard_path
        from sheeprl_tpu_torch.resilience.sharded import is_partial_checkpoint, load_sharded_checkpoint
        from sheeprl_tpu_torch.utils.checkpoint import load_state

        if is_partial_checkpoint(path):
            return load_sharded_checkpoint(path)
        if self.global_rank > 0 and os.path.isfile(rank_shard_path(path, self.global_rank)):
            path = rank_shard_path(path, self.global_rank)
        return load_state(path)
