"""The ``Runtime`` (counterpart of ``sheeprl_tpu/parallel/runtime.py``):
the data axis of ``fabric.devices`` shards and, with ``fabric.fsdp`` = k >
1, their ``(data, model)`` layout of ``(N // k, k)`` (``parallel/mesh.py``,
``parallel/fsdp.py``), the
precision policy (``param_dtype``, ``compute_dtype``, the dtypes the run
trains in: ``64-true`` trains in float32, as the JAX package does; see
``parallel/precision.py``), the seeding, checkpoint save/load and the
callback hooks.

One process drives every shard, as the JAX package's single controller
does: ``devices`` lists each shard's device in shard order, ``device`` is
shard 0's (the player's), ``world_size`` is the shard count, the process
is rank 0, and ``all_gather`` / ``broadcast`` / ``barrier`` are the
identities of one process.  ``save`` writes the state it is given (the
loops pass shard 0's replica, with the optimizer state gathered under FSDP)
as one file with its manifest, through the diagnostics' resilience layer
when it is open (``diagnostics``, attached by ``cli.run_algorithm``);
under FSDP as a partial-shard group of k files, synchronously, as the JAX
runtime writes it (``resilience/sharded.py``).  ``load`` returns one tree,
a partial group reassembled, which the loops place, so a checkpoint
crosses between shard counts, axis sizes and packages.  More than one node
is refused, naming its ROADMAP item."""

from __future__ import annotations

import random
import warnings
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.parallel.mesh import mesh_position, placement, shared_devices
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


def shard_count(devices: Any, accelerator: Any) -> int:
    """``fabric.devices`` as a shard count: ``auto`` / ``-1`` mean every
    device the accelerator has (one on the CPU)."""
    if str(devices) in ("auto", "-1"):
        return 1 if str(accelerator) == "cpu" else max(1, torch.cuda.device_count())
    n = int(devices)
    if n < 1:
        raise ValueError(f"fabric.devices must be a positive count, 'auto' or -1, got {devices!r}")
    return n


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
        if int(num_nodes) != 1:
            raise NotImplementedError(
                f"fabric.num_nodes={num_nodes}: multi-device training over more than one node {_NOT_PORTED}, "
                "Parallel: multi-host"
            )
        self.param_dtype, self.compute_dtype = training_dtypes(precision)
        if resolve_precision(precision)[1] == torch.float64:
            warnings.warn(
                f"fabric.precision={precision!r} requests float64; the run trains in float32, as the JAX package "
                "does without jax_enable_x64 (its float64 casts truncate to float32)",
                UserWarning,
            )
        n = shard_count(devices, accelerator)
        self.fsdp = int(fsdp or 1)
        self.fsdp_min_shard_bytes = None if fsdp_min_shard_bytes is None else int(fsdp_min_shard_bytes)
        if n % self.fsdp != 0:
            raise ValueError(f"fsdp axis size ({self.fsdp}) must divide the device count ({n})")
        self.devices = placement(n, accelerator)
        self.device = self.devices[0]
        self.callbacks = list(callbacks or [])
        self.diagnostics = None
        if self.world_size > 1:
            print(f"[data axis] {self.world_size} shards: "
                  + ", ".join(f"shard {i} -> {d}" for i, d in enumerate(self.devices)), flush=True)
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

    global_rank = 0
    is_global_zero = True

    @property
    def world_size(self) -> int:
        return len(self.devices)

    def all_gather(self, tree: Any) -> Any:
        """The identity: one process holds every shard's values."""
        return tree

    def broadcast(self, obj: Any, src: int = 0) -> Any:
        """The identity: one process."""
        return obj

    def barrier(self) -> None:
        """Nothing to wait for: one process."""

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
        Under FSDP a partial-shard group (``ckpt_<step>_<k>.ckpt``, one a
        model shard, each holding the slices the rule gives it, shard 0
        written last), synchronously, as the JAX runtime writes it."""
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
        package's) reassembled whole, whatever this run's axis size."""
        from sheeprl_tpu_torch.resilience.sharded import is_partial_checkpoint, load_sharded_checkpoint
        from sheeprl_tpu_torch.utils.checkpoint import load_state

        if is_partial_checkpoint(path):
            return load_sharded_checkpoint(path)
        return load_state(path)
