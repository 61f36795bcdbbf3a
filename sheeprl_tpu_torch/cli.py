"""Command-line entry points (counterpart of ``sheeprl_tpu/cli.py``):
``run`` trains or, with ``checkpoint.resume_from``, resumes; ``eval`` scores
a checkpoint; ``serve`` serves one.  The port trains and evaluates
``dreamer_v3``, ``dreamer_v3_jepa``, ``p2e_dv3_exploration``,
``p2e_dv3_finetuning``, ``ppo``, ``a2c``, ``sac``, ``droq``, ``sac_ae``,
``dreamer_v2``, ``dreamer_v1``, ``ppo_recurrent`` and the exploration and
finetuning of ``p2e_dv2`` and ``p2e_dv1``, trains the decoupled
player/trainer loops ``ppo_decoupled`` and ``sac_decoupled`` (which, as in
the JAX package, have no evaluation), trains ``sac``, ``droq`` and
``dreamer_v3`` offline (``algo.offline.enabled=true``, on a dataset
``buffer.export`` or ``python -m sheeprl_tpu_torch export`` wrote), and
serves ``dreamer_v3``, ``ppo``, ``a2c``, ``sac`` and ``ppo_recurrent`` (as
the JAX package does) with its operations: hot reload, more models, the
request log, SLOs, ``/metrics`` and the trace.  ``registration``
publishes a checkpoint's models to the MLflow registry; a run with
``model_manager.disabled=False`` registers its models at its end where the
JAX loop does, and ``metric.profiler.enabled=True`` traces the whole run
with ``torch.profiler``."""

from __future__ import annotations

import contextlib
import os
import pathlib
import sys
import time
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
    config and serve it over HTTP, promoting newer checkpoints of its
    directory as they appear.  Other overrides are dotted keys on top of the
    archived config (``serving.port=8080``, ``fabric.accelerator=cpu``,
    ``serving.models={canary: ...}``)."""
    from sheeprl_tpu_torch.serving.server import serve_checkpoint

    serve_checkpoint(*serve_config(args))


#: ``fabric.strategy`` values the JAX package knows; another one warns (one
#: device runs any of them the same)
KNOWN_STRATEGIES = ("auto", "dp", "ddp", "single")
#: ``matmul_precision`` -> ``torch.set_float32_matmul_precision``'s value
#: (None: torch's own, full fp32): the JAX names for fp32, TF32 and bf16
#: products
MATMUL_PRECISION = {"default": None, "highest": "highest", "float32": "highest", "high": "high",
                    "tensorfloat32": "high", "bfloat16": "medium"}


def check_configs(cfg: dotdict) -> None:
    """The checks of the JAX package's ``check_configs`` that a ported
    algorithm needs; options the port does not run raise where the
    algorithm reads them."""
    from sheeprl_tpu_torch.utils.registry import find_algorithm

    entry = find_algorithm(cfg.algo.name)
    if entry is None:
        raise NotImplementedError(
            f"Algorithm {cfg.algo.name!r} is not ported yet (see ROADMAP.md Queue 1); the port trains: dreamer_v3, "
            "dreamer_v3_jepa, p2e_dv3_exploration, p2e_dv3_finetuning, ppo, ppo_decoupled, a2c, sac, "
            "sac_decoupled, droq, sac_ae, dreamer_v2, dreamer_v1, ppo_recurrent, p2e_dv2_exploration, "
            "p2e_dv2_finetuning, p2e_dv1_exploration, p2e_dv1_finetuning"
        )
    if cfg.get("matmul_precision", "default") not in MATMUL_PRECISION:
        raise ValueError(
            f"Invalid 'matmul_precision' value {cfg.get('matmul_precision')!r}; "
            "must be one of: default, high, highest, tensorfloat32, bfloat16, float32"
        )
    strategy = str(cfg.fabric.get("strategy", "auto")).lower()
    if entry["decoupled"]:
        _check_decoupled(cfg, strategy)
    elif strategy not in KNOWN_STRATEGIES:
        warnings.warn(
            f"Unknown fabric.strategy {strategy!r}; the runtime treats it as 'auto' (known: {KNOWN_STRATEGIES})",
            UserWarning,
        )
    if cfg.metric.log_level not in (0, 1):
        raise ValueError(f"metric.log_level must be 0 or 1, got {cfg.metric.log_level}")
    _check_fsdp(cfg)
    _check_processes(cfg, entry["decoupled"])
    _check_offline(cfg)
    _check_diagnostics(cfg)
    _check_resilience(cfg)
    _check_rssm_chunks(cfg)
    learning_starts = cfg.algo.get("learning_starts")
    if learning_starts is not None and learning_starts < 0:
        raise ValueError("The `algo.learning_starts` parameter must be greater or equal to zero")
    if cfg.env.get("action_repeat", 1) < 1:
        warnings.warn(
            f"env.action_repeat={cfg.env.action_repeat} is below the minimum of 1; clamping to 1",
            UserWarning,
        )
        cfg.env.action_repeat = 1
    if not cfg.model_manager.get("disabled", True):
        from sheeprl_tpu_torch.utils.imports import _IS_MLFLOW_AVAILABLE

        if not _IS_MLFLOW_AVAILABLE:
            warnings.warn("MLFlow is not installed; setting model_manager.disabled=True", UserWarning)
            cfg.model_manager.disabled = True


def _check_decoupled(cfg: dotdict, strategy: str) -> None:
    """The JAX ``check_configs``' rules for a decoupled (player/trainer)
    algorithm: a data-parallel strategy and, where ``fabric.devices`` is an
    explicit count, at least two devices (``auto`` reaches the loop, which
    checks the count it resolves to)."""
    algo_name = cfg.algo.name
    if strategy not in ("auto", "dp", "ddp"):
        raise ValueError(
            f"Decoupled algorithm '{algo_name}' needs a data-parallel mesh (fabric.strategy=auto|dp), got {strategy!r}"
        )
    devices = cfg.fabric.devices
    n = devices if isinstance(devices, int) else 0
    if isinstance(devices, str) and devices not in ("auto", "-1"):
        n = int(devices)
    if 0 < n < 2:
        raise RuntimeError(
            f"Decoupled algorithm '{algo_name}' needs at least 2 devices (1 player + >=1 trainer), "
            f"got fabric.devices={devices}"
        )


def _check_diagnostics(cfg: dotdict) -> None:
    """The JAX ``check_configs``' telemetry, watchdog, goodput, snapshot
    and learning-health checks, with its errors: a bad knob fails before
    the log dir exists, not hours into a run."""
    diag_cfg = cfg.get("diagnostics") or {}
    telemetry_cfg = diag_cfg.get("telemetry") or {}
    port = (telemetry_cfg.get("http") or {}).get("port", 0) or 0
    if not isinstance(port, int) or port < 0 or port > 65535:
        raise ValueError(
            f"diagnostics.telemetry.http.port must be an integer in [0, 65535] (0 = ephemeral), got {port!r}"
        )
    storm_threshold = (telemetry_cfg.get("watchdog") or {}).get("storm_threshold")
    if storm_threshold is not None and int(storm_threshold) < 1:
        raise ValueError(f"diagnostics.telemetry.watchdog.storm_threshold must be >= 1, got {storm_threshold!r}")
    goodput_cfg = diag_cfg.get("goodput") or {}
    goodput_wd_cfg = goodput_cfg.get("watchdog") or {}
    for knob in ("heartbeat_s", "stall_threshold_s"):
        value = goodput_wd_cfg.get(knob)
        if value is not None and float(value) <= 0:
            raise ValueError(
                f"diagnostics.goodput.watchdog.{knob} must be > 0 or null (null disables the watchdog), got {value!r}"
            )
    if goodput_cfg.get("enabled", True) and (goodput_cfg.get("profile") or {}).get("enabled", False):
        max_ms = goodput_cfg.profile.get("max_ms")
        if max_ms is not None and float(max_ms) < 10:
            raise ValueError(
                f"diagnostics.goodput.profile.max_ms must be >= 10 (the capture floor), got {max_ms!r}; "
                "set diagnostics.goodput.profile.enabled=False instead"
            )
    res_cfg = diag_cfg.get("resilience") or {}
    max_pending = res_cfg.get("max_pending_snapshots")
    if max_pending is not None and int(max_pending) < 1:
        raise ValueError(f"diagnostics.resilience.max_pending_snapshots must be >= 1, got {max_pending!r}")
    inject_preempt = res_cfg.get("inject_preempt_iter")
    if inject_preempt is not None and int(inject_preempt) < 1:
        raise ValueError(
            f"diagnostics.resilience.inject_preempt_iter must be >= 1 (1 = first iteration) or null, "
            f"got {inject_preempt!r}"
        )
    health_cfg = diag_cfg.get("health") or {}
    confirm = health_cfg.get("confirm")
    if confirm is not None and int(confirm) < 1:
        raise ValueError(f"diagnostics.health.confirm must be >= 1, got {confirm!r}")
    detectors = health_cfg.get("detectors") or {}
    low, high = detectors.get("update_ratio_low"), detectors.get("update_ratio_high")
    if low is not None and high is not None and float(low) >= float(high):
        raise ValueError(
            f"diagnostics.health.detectors.update_ratio_low must be < update_ratio_high, got {low!r} >= {high!r}"
        )
    plateau_window = detectors.get("plateau_window")
    if plateau_window is not None and int(plateau_window) < 2:
        raise ValueError(f"diagnostics.health.detectors.plateau_window must be >= 2, got {plateau_window!r}")
    if health_cfg.get("inject_entropy_collapse_iter") is not None and detectors.get("entropy_floor") is None:
        raise ValueError(
            "diagnostics.health.inject_entropy_collapse_iter requires diagnostics.health.detectors.entropy_floor "
            "— a drill against a disarmed detector could never fire"
        )


#: the algorithms whose loop places the train state under FSDP: the JAX
#: ``check_configs``' literal set (``algo.name``; the Plan2Explore
#: experiments name theirs ``p2e_dv*_exploration`` / ``_finetuning``, which
#: the set does not hold, so the JAX package refuses them too)
FSDP_SUPPORTED = ("dreamer_v3", "dreamer_v3_jepa", "p2e_dv1", "p2e_dv2", "p2e_dv3")


def _check_fsdp(cfg: dotdict) -> None:
    """The JAX ``check_configs``' FSDP rules and errors, at compose time: the
    axis size and the floor in range; with ``fabric.fsdp > 1`` an algorithm
    of :data:`FSDP_SUPPORTED`, no offline mode, and an axis size that
    divides ``fabric.devices``."""
    fsdp_raw = cfg.fabric.get("fsdp", 1)
    fsdp = 1 if fsdp_raw is None else int(fsdp_raw)
    if fsdp < 1:
        raise ValueError(f"distribution.fsdp_axis_size must be >= 1, got {fsdp}")
    min_shard = cfg.fabric.get("fsdp_min_shard_bytes")
    if min_shard is not None and int(min_shard) < 0:
        raise ValueError(f"distribution.fsdp_min_shard_bytes must be >= 0, got {min_shard!r}")
    if fsdp <= 1:
        return
    if cfg.algo.name not in FSDP_SUPPORTED:
        raise ValueError(f"distribution.fsdp_axis_size > 1 supports the DV3 family {list(FSDP_SUPPORTED)}, got "
                         f"algo.name={cfg.algo.name!r}")
    if (cfg.algo.get("offline") or {}).get("enabled"):
        raise ValueError("distribution.fsdp_axis_size > 1 is not supported with algo.offline.enabled=true (the "
                         "offline loop is single-device)")
    n_dev = cfg.fabric.get("devices", 1)
    if isinstance(n_dev, str) and n_dev not in ("auto", "-1"):
        n_dev = int(n_dev)
    if isinstance(n_dev, int) and n_dev > 0 and n_dev % fsdp != 0:
        raise ValueError(f"distribution.fsdp_axis_size ({fsdp}) must divide fabric.devices ({n_dev})")


def _check_processes(cfg: dotdict, decoupled: bool) -> None:
    """What a run over more than one process (``fabric.num_nodes > 1`` with
    torchrun's variables, or a caller's ``torch.distributed`` group) does
    not port yet, refused by name with its ROADMAP item: FSDP
    (``fabric.fsdp > 1``), the decoupled loops, and the replay ring on the
    device (``buffer.device=True``)."""
    from sheeprl_tpu_torch.parallel.runtime import processes_for

    processes = processes_for(cfg.fabric.get("num_nodes", 1))
    if processes <= 1:
        return
    fsdp = int(cfg.fabric.get("fsdp", 1) or 1)
    if fsdp > 1:
        raise NotImplementedError(f"fabric.fsdp={fsdp} over {processes} processes: FSDP across processes is not "
                                  "ported yet: see ROADMAP.md Queue 1, Parallel: FSDP across processes")
    if decoupled:
        raise NotImplementedError(f"exp={cfg.algo.name} over {processes} processes: the decoupled loops across "
                                  "processes are not ported yet: see ROADMAP.md Queue 1, Parallel: decoupled "
                                  "across processes")
    if bool((cfg.get("buffer") or {}).get("device", False)):
        raise NotImplementedError(f"buffer.device=True over {processes} processes: the device replay ring across "
                                  "processes is not ported yet: see ROADMAP.md Queue 1, Parallel: device replay "
                                  "across processes")


def _check_rssm_chunks(cfg: dotdict) -> None:
    """The JAX ``check_configs``' chunked RSSM scan checks (the DreamerV3
    family's ``algo.rssm_chunks``), at compose time, not at the first step."""
    rssm_chunks = cfg.algo.get("rssm_chunks")
    if rssm_chunks is None:
        return
    rssm_chunks = int(rssm_chunks)
    if rssm_chunks < 1:
        raise ValueError(f"algo.rssm_chunks must be >= 1, got {rssm_chunks}")
    burn_in = int(cfg.algo.get("rssm_chunk_burn_in", 0) or 0)
    if burn_in < 0:
        raise ValueError(f"algo.rssm_chunk_burn_in must be >= 0, got {burn_in}")
    seq_len = cfg.algo.get("per_rank_sequence_length")
    if rssm_chunks > 1 and isinstance(seq_len, int):
        if seq_len % rssm_chunks != 0:
            raise ValueError(
                f"algo.rssm_chunks ({rssm_chunks}) must divide algo.per_rank_sequence_length ({seq_len})"
            )
        if burn_in >= seq_len // rssm_chunks:
            raise ValueError(
                f"algo.rssm_chunk_burn_in ({burn_in}) must be < the chunk length "
                f"({seq_len // rssm_chunks} = per_rank_sequence_length / rssm_chunks)"
            )


def _check_resilience(cfg: dotdict) -> None:
    """The JAX ``check_configs``' isolation and chaos checks, so a bad
    budget or schedule fails before the log dir exists: the monitors'
    constructors validate their knobs and open nothing."""
    from sheeprl_tpu_torch.resilience.chaos import ChaosMonitor
    from sheeprl_tpu_torch.resilience.isolation import IsolationMonitor

    IsolationMonitor(cfg)
    ChaosMonitor(cfg)


def _check_offline(cfg: dotdict) -> None:
    """The JAX ``check_configs``' offline gates, with its errors: the mode
    swaps the whole entry point, so a bad knob fails before the log dir
    exists (a decoupled algorithm is none of ``OFFLINE_ALGOS``, so the first
    gate refuses it, as in the JAX package).  ``cql_alpha`` set while the
    mode is off warns: the penalty is a train-step knob, and applies to the
    online critic update too."""
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
    models = getattr(algo_utils, "MODELS_TO_REGISTER", None)
    mm = cfg.model_manager.get("models", {})
    if models is not None and isinstance(mm, dict):
        cfg.model_manager.models = dotdict({k: v for k, v in mm.items() if k in models})
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
        profiler_cfg = cfg.metric.get("profiler") or {}
        if profiler_cfg.get("enabled", False):
            trace_dir = profiler_cfg.get("trace_dir") or os.path.join("logs", "profiler_trace")
            with whole_run_profile(str(trace_dir), runtime.device):
                return runtime.launch(entrypoint, cfg)
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


@contextlib.contextmanager
def whole_run_profile(trace_dir: str, device: torch.device):
    """``metric.profiler.enabled=True``: one ``torch.profiler`` trace of the
    host and (on the card) the device around the whole run, written as a
    Chrome trace ``<trace_dir>/<time>_<pid>.pt.trace.json`` when the run
    ends, however it ends.  It holds every event of the run in memory until
    then, so it grows with the run.  The goodput watchdog's own captures
    report ``busy`` meanwhile (``diagnostics/goodput.py::PROFILER_LOCK``)."""
    from torch.profiler import ProfilerActivity, profile

    from sheeprl_tpu_torch.diagnostics.goodput import PROFILER_LOCK

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.pt.trace.json")
    with PROFILER_LOCK:
        prof = profile(activities=activities)
        prof.start()
        try:
            yield path
        finally:
            prof.stop()
            prof.export_chrome_trace(path)


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
    n_threads = cfg.get("num_threads")
    if n_threads and int(n_threads) > 0:
        # the host's thread budget: BLAS pools already running in this
        # process keep theirs; the env workers it spawns read these
        for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
            os.environ.setdefault(var, str(int(n_threads)))
    if cfg.checkpoint.get("resume_from"):
        cfg = resume_from_checkpoint(cfg, overrides)
    check_configs(cfg)
    precision = MATMUL_PRECISION[cfg.get("matmul_precision", "default")]
    if precision is not None:
        torch.set_float32_matmul_precision(precision)
    return run_algorithm(cfg)


def eval_algorithm(cfg: dotdict) -> Any:
    """Registry lookup -> runtime -> the checkpoint -> the algorithm's
    evaluation; returns what it returns (the test reward)."""
    import importlib

    from sheeprl_tpu_torch.utils.registry import evaluation_registry, find_evaluation

    entry = find_evaluation(cfg.algo.name)
    if entry is None:
        # the JAX package's refusal (it registers no evaluation of the
        # decoupled loops, whose checkpoints then have none either)
        registered = sorted({m["name"] for v in evaluation_registry.values() for m in v})
        raise ValueError(f"Evaluation for algorithm '{cfg.algo.name}' is not registered. Available: {registered}")
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
        # wandb's and mlflow's archived configs carry no `name`: their
        # backends take the run name as their own keyword, as the JAX eval
        # passes it
        target = str(logger_cfg.get("_target_", ""))
        if target.endswith("WandbLogger"):
            logger_cfg.name = cfg.run_name
        elif target.endswith("MLFlowLogger"):
            logger_cfg.run_name = cfg.run_name
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


def registration(args: Optional[Sequence[str]] = None) -> None:
    """``python -m sheeprl_tpu_torch registration checkpoint_path=...
    [dotted.key=value ...]``: publish the models of a checkpoint (either
    package's) that its archived ``model_manager.models`` names to the
    MLflow registry.  Raises ``ModuleNotFoundError`` without mlflow, as the
    JAX entry point does."""
    flat = _dotted_overrides(list(args if args is not None else sys.argv[1:]))
    ckpt = flat.pop("checkpoint_path", None)
    if ckpt is None:
        raise ValueError("You must specify the checkpoint path: checkpoint_path=...")
    ckpt_path = pathlib.Path(ckpt)
    cfg = _archived_config(ckpt_path)
    deep_merge(cfg, dotdict(nest_dotted(flat)))
    cfg.checkpoint_path = str(ckpt_path)
    from sheeprl_tpu_torch.utils.mlflow import register_model_from_checkpoint

    register_model_from_checkpoint(cfg)
