"""Command-line entry points (counterpart of ``sheeprl_tpu/cli.py``):
``run`` trains, ``serve`` serves a checkpoint.  Evaluation, resume and
registration are still to port (ROADMAP.md Queue 1)."""

from __future__ import annotations

import pathlib
import sys
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import yaml

from sheeprl_tpu_torch.config import compose, compose_group, deep_merge, instantiate
from sheeprl_tpu_torch.parallel.runtime import resolve_device
from sheeprl_tpu_torch.utils.utils import dotdict, nest_dotted


def select_device(cfg) -> torch.device:
    """``fabric.accelerator=cpu`` runs on the CPU; anything else means CUDA,
    and then a missing CUDA device is an error, not a reason to fall back
    (:func:`~sheeprl_tpu_torch.parallel.runtime.resolve_device`)."""
    return resolve_device(cfg.fabric.get("accelerator", "auto"))


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


def check_configs(cfg: dotdict) -> None:
    """The checks of the JAX package's ``check_configs`` that a ported
    algorithm needs; options the port does not run raise where the
    algorithm reads them."""
    from sheeprl_tpu_torch.utils.registry import find_algorithm

    if find_algorithm(cfg.algo.name) is None:
        raise NotImplementedError(
            f"Algorithm {cfg.algo.name!r} is not ported yet (see ROADMAP.md Queue 1); the port trains: dreamer_v3"
        )
    if cfg.metric.log_level not in (0, 1):
        raise ValueError(f"metric.log_level must be 0 or 1, got {cfg.metric.log_level}")
    learning_starts = cfg.algo.get("learning_starts")
    if learning_starts is not None and learning_starts < 0:
        raise ValueError("The `algo.learning_starts` parameter must be greater or equal to zero")


def run_algorithm(cfg: dotdict) -> Any:
    """Registry lookup -> runtime -> the algorithm's entry point; returns
    what the entry point returns."""
    import importlib

    from sheeprl_tpu_torch.utils.registry import find_algorithm

    entry = find_algorithm(cfg.algo.name)
    algo_utils = importlib.import_module(entry["module"].rsplit(".", 1)[0] + ".utils")
    keys = getattr(algo_utils, "AGGREGATOR_KEYS", None)
    metrics_cfg = cfg.metric.aggregator.get("metrics", {})
    if keys is not None and isinstance(metrics_cfg, dict):
        cfg.metric.aggregator.metrics = dotdict({k: v for k, v in metrics_cfg.items() if k in keys})
    entrypoint = getattr(importlib.import_module(entry["module"]), entry["entrypoint"])
    runtime = instantiate(cfg.fabric)
    return runtime.launch(entrypoint, cfg)


def run(args: Optional[Sequence[str]] = None) -> Any:
    """``python -m sheeprl_tpu_torch run exp=dreamer_v3 env=dummy
    diagnostics=off [fabric.accelerator=cpu] ...``: compose the config from
    Hydra-style overrides and train.  On the card unless
    ``fabric.accelerator=cpu``."""
    cfg = compose(list(args if args is not None else sys.argv[1:]))
    check_configs(cfg)
    return run_algorithm(cfg)
