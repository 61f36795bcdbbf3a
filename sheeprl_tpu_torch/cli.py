"""Command-line entry points (counterpart of ``sheeprl_tpu/cli.py``):
``run`` trains or, with ``checkpoint.resume_from``, resumes; ``eval`` scores
a checkpoint; ``serve`` serves one.  The port trains and evaluates
``dreamer_v3``, ``dreamer_v3_jepa``, ``p2e_dv3_exploration``,
``p2e_dv3_finetuning``, ``ppo``, ``a2c``, ``sac``, ``droq``, ``sac_ae``,
``dreamer_v2``, ``dreamer_v1``, ``ppo_recurrent`` and the exploration and
finetuning of ``p2e_dv2`` and ``p2e_dv1``, trains ``sac``, ``droq`` and
``dreamer_v3`` offline (``algo.offline.enabled=true``, on a dataset
``buffer.export`` or ``python -m sheeprl_tpu_torch export`` wrote), and
serves ``dreamer_v3``, ``ppo``, ``a2c``, ``sac`` and ``ppo_recurrent`` (as
the JAX package does); model registration is still to port (ROADMAP.md
Queue 1)."""

from __future__ import annotations

import os
import pathlib
import sys
import warnings
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import yaml

from sheeprl_tpu_torch.config import compose, compose_group, deep_merge, instantiate, own_targets, yaml_load
from sheeprl_tpu_torch.parallel.runtime import resolve_device
from sheeprl_tpu_torch.utils.utils import dotdict, nest_dotted


def select_device(cfg) -> torch.device:
    """``fabric.accelerator=cpu`` runs on the CPU; anything else means CUDA,
    and then a missing CUDA device is an error, not a reason to fall back
    (:func:`~sheeprl_tpu_torch.parallel.runtime.resolve_device`)."""
    return resolve_device(cfg.fabric.get("accelerator", "auto"))


def _dotted_overrides(overrides: Sequence[str]) -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for ov in overrides:
        key, _, value = ov.partition("=")
        flat[key.lstrip("+")] = yaml.safe_load(value) if value != "" else None
    return flat


def _archived_config(ckpt_path: pathlib.Path) -> dotdict:
    """The run config archived two levels up from a checkpoint, its targets
    the port's (:func:`~sheeprl_tpu_torch.config.own_targets`)."""
    cfg_path = ckpt_path.parent.parent / "config.yaml"
    if not cfg_path.is_file():
        raise FileNotFoundError(f"Archived run config not found at '{cfg_path}'")
    with open(cfg_path) as fp:
        return dotdict(own_targets(yaml.safe_load(fp)))


def serve_config(args: Optional[Sequence[str]] = None) -> Tuple[dotdict, str, torch.device]:
    """``serve``'s configuration: the checkpoint's archived ``config.yaml``
    (two levels up from the checkpoint), the ``serving`` group defaults under
    it, dotted overrides on top, and the device it selects."""
    flat = _dotted_overrides(list(args if args is not None else sys.argv[1:]))
    ckpt = flat.pop("checkpoint_path", None)
    if ckpt is None:
        raise ValueError("You must specify the checkpoint path: checkpoint_path=...")
    ckpt_path = pathlib.Path(ckpt)
    cfg = _archived_config(ckpt_path)
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
            f"Algorithm {cfg.algo.name!r} is not ported yet (see ROADMAP.md Queue 1); the port trains: dreamer_v3, "
            "dreamer_v3_jepa, p2e_dv3_exploration, p2e_dv3_finetuning, ppo, a2c, sac, droq, sac_ae, dreamer_v2, "
            "dreamer_v1, ppo_recurrent, p2e_dv2_exploration, p2e_dv2_finetuning, p2e_dv1_exploration, "
            "p2e_dv1_finetuning"
        )
    if cfg.metric.log_level not in (0, 1):
        raise ValueError(f"metric.log_level must be 0 or 1, got {cfg.metric.log_level}")
    _check_offline(cfg)
    learning_starts = cfg.algo.get("learning_starts")
    if learning_starts is not None and learning_starts < 0:
        raise ValueError("The `algo.learning_starts` parameter must be greater or equal to zero")


def _check_offline(cfg: dotdict) -> None:
    """The JAX ``check_configs``' offline gates, with its errors: the mode
    swaps the whole entry point, so a bad knob fails before the log dir
    exists.  ``cql_alpha`` set while the mode is off warns: the penalty is a
    train-step knob, and applies to the online critic update too."""
    from sheeprl_tpu_torch.offline.train import OFFLINE_ALGOS

    offline_cfg = cfg.algo.get("offline") or {}
    algo_name = cfg.algo.name
    if offline_cfg.get("enabled"):
        if algo_name not in OFFLINE_ALGOS:
            raise ValueError(
                f"algo.offline.enabled=true supports {list(OFFLINE_ALGOS)}, got algo.name={algo_name!r}"
            )
        if not offline_cfg.get("dataset_dir"):
            raise ValueError(
                "algo.offline.enabled=true requires algo.offline.dataset_dir "
                "(an exported dataset: buffer.export=True or `python -m sheeprl_tpu_torch export <run dir>`)"
            )
        if float(offline_cfg.get("cql_alpha", 0.0) or 0.0) < 0:
            raise ValueError(f"algo.offline.cql_alpha must be >= 0, got {offline_cfg.get('cql_alpha')!r}")
        cql_samples = offline_cfg.get("cql_samples")
        if cql_samples is not None and int(cql_samples) < 1:
            raise ValueError(f"algo.offline.cql_samples must be >= 1, got {cql_samples!r}")
        grad_steps = offline_cfg.get("grad_steps_per_iter")
        if grad_steps is not None and int(grad_steps) < 1:
            raise ValueError(f"algo.offline.grad_steps_per_iter must be >= 1, got {grad_steps!r}")
        if int(offline_cfg.get("prefetch", 2) or 0) < 0:
            raise ValueError(
                f"algo.offline.prefetch must be >= 0 (0 disables the prefetch thread), "
                f"got {offline_cfg.get('prefetch')!r}"
            )
        seq = offline_cfg.get("sequence_length")
        if seq is not None and int(seq) < 1:
            raise ValueError(f"algo.offline.sequence_length must be >= 1 or null, got {seq!r}")
    elif float(offline_cfg.get("cql_alpha", 0.0) or 0.0) != 0.0:
        warnings.warn(
            "algo.offline.cql_alpha is set but algo.offline.enabled=false: the conservative "
            "penalty WILL apply to the online run's critic update too (it is a train-step "
            "knob); set it to 0 unless that is intended",
            UserWarning,
        )


def run_algorithm(cfg: dotdict) -> Any:
    """Registry lookup -> runtime -> the algorithm's entry point, or with
    ``algo.offline.enabled`` the env-free offline loop
    (``offline/train.py::offline_main``); returns what it returns."""
    import importlib

    from sheeprl_tpu_torch.utils.registry import find_algorithm

    entry = find_algorithm(cfg.algo.name)
    algo_utils = importlib.import_module(entry["module"].rsplit(".", 1)[0] + ".utils")
    keys = getattr(algo_utils, "AGGREGATOR_KEYS", None)
    metrics_cfg = cfg.metric.aggregator.get("metrics", {})
    if keys is not None and isinstance(metrics_cfg, dict):
        cfg.metric.aggregator.metrics = dotdict({k: v for k, v in metrics_cfg.items() if k in keys})
    if (cfg.algo.get("offline") or {}).get("enabled"):
        from sheeprl_tpu_torch.offline.train import offline_main

        entrypoint = offline_main
    else:
        entrypoint = getattr(importlib.import_module(entry["module"]), entry["entrypoint"])
    runtime = instantiate(cfg.fabric)
    # the run-health facade: attached here, opened by the loop once its log
    # dir exists; closed here with the run's status whatever happens
    from sheeprl_tpu_torch.diagnostics import SentinelHalt, build_diagnostics
    from sheeprl_tpu_torch.resilience.preemption import PreemptedExit

    diagnostics = runtime.diagnostics = build_diagnostics(cfg)
    status = "completed"
    try:
        return runtime.launch(entrypoint, cfg)
    except SentinelHalt:
        status = "halted"
        raise
    except PreemptedExit:
        # the loop journaled `preempted` and closed the facade already
        status = "preempted"
        raise
    except BaseException:
        status = "aborted"
        raise
    finally:
        diagnostics.close(status)


def resume_from_checkpoint(cfg: dotdict, overrides: Sequence[str] = ()) -> dotdict:
    """The config of a resumed run.  ``checkpoint.resume_from`` is a
    checkpoint file or any directory above one; it resolves to the newest
    checkpoint that verifies (``resilience/manifest.py``), which
    ``keep_last`` then never deletes.  The run config archived beside it is
    the base; the allowed top-level keys come from ``cfg``, and of ``env``,
    ``diagnostics`` and ``algo.offline`` only what ``overrides`` passes
    explicitly (a group swap takes the whole composed block), so that every
    archived setting the user did not type keeps its value.  The env id and
    the algorithm must match the archive's."""
    from sheeprl_tpu_torch.resilience.manifest import resolve_resume_from
    from sheeprl_tpu_torch.utils.checkpoint import protect_checkpoint

    resolved = resolve_resume_from(str(cfg.checkpoint.resume_from))
    protect_checkpoint(resolved)
    ckpt_path = pathlib.Path(resolved)
    old_cfg = _archived_config(ckpt_path)
    if old_cfg.env.id != cfg.env.id:
        raise ValueError(
            "This experiment is run with a different environment from the one of the experiment you want to "
            f"restart: got '{cfg.env.id}', expected '{old_cfg.env.id}'"
        )
    if old_cfg.algo.name != cfg.algo.name:
        raise ValueError(
            "This experiment is run with a different algorithm from the one of the experiment you want to "
            f"restart: got '{cfg.algo.name}', expected '{old_cfg.algo.name}'"
        )
    merged = dotdict(old_cfg)
    for key in ("checkpoint", "fabric", "metric", "run_name", "exp_name", "seed", "dry_run", "total_steps"):
        if key in cfg:
            merged[key] = cfg[key]
    explicit: Dict[str, Any] = {}
    for ov in overrides:
        key, _, value = ov.partition("=")
        key = key.lstrip("+~")
        offline_key = key == "algo.offline" or key.startswith("algo.offline.")
        if key.split(".", 1)[0] not in ("env", "diagnostics") and not offline_key:
            continue
        if "." in key and key != "algo.offline":
            explicit[key] = yaml_load(value) if value != "" else None
        else:
            explicit[key] = cfg.get(key) if "." not in key else yaml_load(value)
    if explicit:
        deep_merge(merged, dotdict(nest_dotted(explicit)))
    merged.checkpoint.resume_from = str(ckpt_path)
    merged.root_dir = old_cfg.root_dir
    return merged


def run(args: Optional[Sequence[str]] = None) -> Any:
    """``python -m sheeprl_tpu_torch run exp=dreamer_v3 env=dummy
    [fabric.accelerator=cpu] ...``: compose the config from
    Hydra-style overrides and train, or with ``checkpoint.resume_from=<file
    or run dir>`` resume (:func:`resume_from_checkpoint`).  On the card
    unless ``fabric.accelerator=cpu``."""
    overrides = list(args if args is not None else sys.argv[1:])
    cfg = compose(overrides)
    if cfg.checkpoint.get("resume_from"):
        cfg = resume_from_checkpoint(cfg, overrides)
    check_configs(cfg)
    return run_algorithm(cfg)


def eval_algorithm(cfg: dotdict) -> Any:
    """Registry lookup -> runtime -> the checkpoint -> the algorithm's
    evaluation; returns what it returns (the test reward)."""
    import importlib

    from sheeprl_tpu_torch.utils.registry import find_evaluation

    entry = find_evaluation(cfg.algo.name)
    if entry is None:
        raise NotImplementedError(f"Evaluation of {cfg.algo.name!r} is not ported yet (see ROADMAP.md Queue 1); "
                                  "the port evaluates: dreamer_v3, dreamer_v3_jepa, p2e_dv3_exploration, "
                                  "p2e_dv3_finetuning, ppo, a2c, sac, droq, sac_ae, dreamer_v2, dreamer_v1, "
                                  "ppo_recurrent, p2e_dv2_exploration, p2e_dv2_finetuning, p2e_dv1_exploration, "
                                  "p2e_dv1_finetuning")
    entrypoint = getattr(importlib.import_module(entry["module"]), entry["entrypoint"])
    runtime = instantiate(cfg.fabric)
    return runtime.launch(entrypoint, cfg, runtime.load(cfg.checkpoint_path))


def evaluation(args: Optional[Sequence[str]] = None) -> Any:
    """``python -m sheeprl_tpu_torch eval checkpoint_path=... [dotted.key=value
    ...]``: the checkpoint's archived config with the overrides on top, run
    as ``<run>_evaluation`` with the archived logger re-rooted there (unless
    ``metric.logger`` is overridden), on one device and one env, at the
    archived precision.  Returns what the evaluation returns."""
    flat = _dotted_overrides(list(args if args is not None else sys.argv[1:]))
    if flat.get("checkpoint_path") is None:
        raise ValueError("You must specify the evaluation checkpoint path: checkpoint_path=...")
    ckpt_path = pathlib.Path(flat.pop("checkpoint_path"))
    cfg = _archived_config(ckpt_path)
    deep_merge(cfg, dotdict(nest_dotted(flat)))
    if "run_name" not in flat:
        cfg.run_name = f"{os.path.basename(str(ckpt_path.parent.parent))}_evaluation"
    user_logger = any(k == "metric.logger" or k.startswith("metric.logger.") for k in flat) or (
        isinstance(flat.get("metric"), dict) and "logger" in flat["metric"])
    logger_cfg = cfg.metric.get("logger")
    if logger_cfg is not None and not user_logger:
        # the archived paths point inside the trained run: the evaluation
        # logs under its own run name
        for key in ("root_dir", "save_dir"):
            if key in logger_cfg:
                logger_cfg[key] = os.path.join("logs", "runs", str(cfg.root_dir))
        if "name" in logger_cfg:
            logger_cfg.name = cfg.run_name
    cfg.checkpoint_path = str(ckpt_path)
    cfg.fabric = dotdict({
        "_target_": "sheeprl_tpu_torch.parallel.runtime.Runtime",
        "devices": 1,
        "num_nodes": 1,
        "strategy": "auto",
        "accelerator": cfg.fabric.get("accelerator", "auto"),
        "precision": cfg.fabric.get("precision", "32-true"),
    })
    cfg.env.num_envs = 1
    return eval_algorithm(cfg)
