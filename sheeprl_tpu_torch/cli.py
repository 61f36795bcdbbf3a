"""Command-line entry points (counterpart of ``sheeprl_tpu/cli.py``; the
serving slice ports ``serve``)."""

from __future__ import annotations

import pathlib
import sys
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import yaml

from sheeprl_tpu_torch.config import compose_group, deep_merge
from sheeprl_tpu_torch.utils.utils import dotdict, nest_dotted


def select_device(cfg) -> torch.device:
    """``fabric.accelerator=cpu`` runs on the CPU; anything else means CUDA,
    and then a missing CUDA device is an error, not a reason to fall back."""
    if str(cfg.fabric.get("accelerator", "auto")) == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"fabric.accelerator={cfg.fabric.get('accelerator')!r} selects a CUDA device and none is available; "
            "pass fabric.accelerator=cpu to run on the CPU"
        )
    # fp32 everywhere on the serving path: a policy served from a checkpoint
    # should act as the trained one did, and TF32 (about three decimal
    # digits) can flip a near-tied argmax.  PyTorch's default already keeps
    # matmuls in fp32; convolutions default to TF32 through cuDNN.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def serve_config(args: Optional[Sequence[str]] = None) -> Tuple[dotdict, str, torch.device]:
    """``serve``'s configuration: the checkpoint's archived ``config.yaml``
    (two levels up from the checkpoint), the ``serving`` group defaults under
    it, dotted overrides on top, and the device it selects."""
    overrides = list(args if args is not None else sys.argv[1:])
    flat: Dict[str, Any] = {}
    for ov in overrides:
        key, _, value = ov.partition("=")
        flat[key.lstrip("+")] = yaml.safe_load(value) if value != "" else None
    ckpt = flat.pop("checkpoint_path", None)
    if ckpt is None:
        raise ValueError("You must specify the checkpoint path: checkpoint_path=...")
    ckpt_path = pathlib.Path(ckpt)
    cfg_path = ckpt_path.parent.parent / "config.yaml"
    if not cfg_path.is_file():
        raise FileNotFoundError(f"Archived run config not found at '{cfg_path}'")
    with open(cfg_path) as fp:
        cfg = dotdict(yaml.safe_load(fp))
    deep_merge(cfg, dotdict(nest_dotted(flat)))
    # the group defaults underpin whatever the archive / overrides carry, so
    # every serving knob has a value
    serving = compose_group("serving", "default")
    deep_merge(serving, cfg.get("serving") or {})
    cfg.serving = serving
    return cfg, str(ckpt_path), select_device(cfg)


def serve(args: Optional[Sequence[str]] = None) -> None:
    """``python -m sheeprl_tpu_torch serve checkpoint_path=...``: load a
    checkpoint (the JAX package's or the port's) with its archived run
    config and serve it over HTTP.  Other overrides are dotted keys on top
    of the archived config (``serving.port=8080``, ``fabric.accelerator=cpu``)."""
    from sheeprl_tpu_torch.serving.server import serve_checkpoint

    serve_checkpoint(*serve_config(args))
