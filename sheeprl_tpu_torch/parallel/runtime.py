"""The one-device ``Runtime`` (counterpart of
``sheeprl_tpu/parallel/runtime.py``): the device, the precision policy
(``param_dtype``, ``compute_dtype``; see ``parallel/precision.py``), the
seeding, checkpoint save/load and the callback hooks.  ``world_size`` is 1;
multi-device runs and FSDP are still to port (ROADMAP.md Queue 1).  Every
save writes a manifest sidecar, through the diagnostics' resilience layer
when it is open (``diagnostics``, attached by ``cli.run_algorithm``)."""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.parallel.precision import resolve_precision

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
        del strategy, fsdp_min_shard_bytes
        if str(devices) != "1" or int(num_nodes) != 1 or int(fsdp or 1) != 1:
            raise NotImplementedError(
                f"fabric.devices={devices}, num_nodes={num_nodes}, fsdp={fsdp}: multi-device training {_NOT_PORTED}"
            )
        self.param_dtype, self.compute_dtype = resolve_precision(precision)
        if self.compute_dtype == torch.float64:
            raise NotImplementedError(
                f"fabric.precision={precision!r}: the LayerNorm-GRU kernel takes float32 or bfloat16"
            )
        self.device = resolve_device(accelerator)
        self.callbacks = list(callbacks or [])
        self.diagnostics = None

    world_size = 1
    global_rank = 0
    is_global_zero = True

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
        open, else a blocking save that writes the manifest all the same."""
        routed = self.diagnostics is not None and self.diagnostics.save_checkpoint(path, state)
        if not routed:
            from sheeprl_tpu_torch.resilience.manifest import save_verified_checkpoint

            save_verified_checkpoint(path, state)

    def load(self, path: str) -> Dict[str, Any]:
        from sheeprl_tpu_torch.utils.checkpoint import load_state

        return load_state(path)
