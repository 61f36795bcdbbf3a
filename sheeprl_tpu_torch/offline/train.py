"""Env-free offline training (``algo.offline.enabled=true``; counterpart of
``sheeprl_tpu/offline/train.py``).

``cli.run_algorithm`` routes here instead of the algorithm's online entry
point: no env or player is built (``envs/env.py::pipelined_vector_env``
refuses to in this mode), and the algorithms' own gradient steps are driven
from the :class:`~sheeprl_tpu_torch.data.datasets.OfflineDataset` loader:

* **SAC / DroQ** on flat transition batches, with the conservative Q
  penalty when ``algo.offline.cql_alpha > 0``;
* **DreamerV3** on contiguous ``[T, B]`` sequence windows: the whole
  gradient step (world model, imagination, actor and critic), through the
  LayerNorm-GRU kernel on the card, ``rssm_*`` stored-state keys included
  for the chunked scan.

The diagnostics stay live: the run journals ``dataset_open`` (and one
``dataset_shard_skipped`` per torn or corrupt shard), the
``Telemetry/dataset_read_sps`` and ``Telemetry/dataset_epoch`` gauges ride
the metric intervals, checkpoints go through the resilience layer and the
sentinel and health hooks see every update.  The step counter of an offline
run counts *gradient steps*: ``algo.total_steps`` is the optimizer-step
budget.  The random streams are the port's (every draw from the run's
generator); the batches are the JAX loader's, draw for draw.

Over ``fabric.devices=N`` shards the loops train as the JAX offline loops
do over their mesh: one replica of the parameters and optimizer state a
shard (the online families' own data axis, ``parallel/dp.py``), a global
batch of ``per_rank_batch_size * N`` rows or sequences a gradient step cut
into the shards' blocks, the gradients, metrics and DreamerV3's Moments
reduced over the shards; the checkpoint holds shard 0's state with the
global ``batch_size``.
"""

from __future__ import annotations

import os
import warnings
from math import prod
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.parallel.dp import local_sample_size, replicas_equal, split

#: Algorithms the offline mode drives (validated in ``cli.check_configs``).
OFFLINE_ALGOS: Tuple[str, ...] = ("sac", "droq", "dreamer_v3")


def offline_main(runtime, cfg) -> Dict[str, Any]:
    """The entry point ``cli.run_algorithm`` launches when
    ``algo.offline.enabled``; returns what the run did."""
    name = cfg.algo.name
    if name in ("sac", "droq"):
        return _offline_flat(runtime, cfg)
    if name == "dreamer_v3":
        return _offline_dreamer(runtime, cfg)
    raise ValueError(f"algo.offline.enabled=true supports {sorted(OFFLINE_ALGOS)}, got algo.name={name!r}")


# ---------------------------------------------------------------------------
# shared scaffold


def _open_run(runtime, cfg):
    """Logger, log dir, diagnostics and the verified dataset: the env-free
    replacement of every online loop's env and player preamble."""
    from sheeprl_tpu_torch.config import instantiate
    from sheeprl_tpu_torch.data.datasets import OfflineDataset
    from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
    from sheeprl_tpu_torch.utils.timer import timer
    from sheeprl_tpu_torch.utils.utils import get_diagnostics, save_configs

    # model_manager is read and registers nothing, as in the JAX offline loop
    offline = cfg.algo.get("offline") or {}
    logger = get_logger(runtime, cfg)
    log_dir = get_log_dir(runtime, cfg.root_dir, cfg.run_name)
    if runtime.is_global_zero:
        save_configs(cfg, log_dir)
        logger.log_hyperparams(cfg.as_dict())
    diag = get_diagnostics(runtime, cfg, log_dir)
    dataset = OfflineDataset(str(offline.get("dataset_dir")), deep_verify=bool(offline.get("deep_verify", True)))
    # one journaled record per torn or corrupt shard, then the open summary:
    # training goes on over the verified remainder
    for skip in dataset.skipped:
        diag._journal_event("dataset_shard_skipped", **skip)
    diag._journal_event("dataset_open", **dataset.summary())
    aggregator = instantiate(cfg.metric.aggregator)
    if cfg.metric.log_level == 0:
        aggregator.disabled = True
    timer.disabled = cfg.metric.log_level == 0 or bool(cfg.metric.get("disable_timer", False))
    timer.reset()
    if cfg.algo.get("run_test"):
        warnings.warn(
            "algo.run_test is ignored in offline mode (there is no environment to test in); "
            "evaluate the final checkpoint with `python -m sheeprl_tpu_torch eval` instead",
            UserWarning,
        )
    return logger, log_dir, diag, dataset, aggregator, offline


def _offline_action_space(act_dim: int, offline: Dict[str, Any]):
    """The dataset actions' space: the ``algo.offline.action_low/high``
    bounds, ±1 when unset (tanh policies need finite bounds, and the
    collecting env's are not part of the dataset record)."""
    from sheeprl_tpu_torch.envs import spaces

    low = offline.get("action_low")
    high = offline.get("action_high")
    low = -1.0 if low is None else low
    high = 1.0 if high is None else high
    low_arr = np.broadcast_to(np.asarray(low, np.float32), (act_dim,)).copy()
    high_arr = np.broadcast_to(np.asarray(high, np.float32), (act_dim,)).copy()
    if not (np.isfinite(low_arr).all() and np.isfinite(high_arr).all()):
        raise ValueError(
            "algo.offline.action_low/high must be finite (tanh policies rescale by them), "
            f"got {low!r} / {high!r}"
        )
    return spaces.Box(low_arr, high_arr, (act_dim,), np.float32)


def _grad_plan(cfg, offline: Dict[str, Any]) -> Tuple[int, int]:
    """``(iterations, gradient steps per iteration)``: ``algo.total_steps``
    is the total optimizer-step budget in offline mode."""
    per_iter = int(offline.get("grad_steps_per_iter", 16) or 16)
    if cfg.dry_run:
        return 1, 1
    total = max(1, int(cfg.algo.total_steps))
    per_iter = max(1, min(per_iter, total))
    return max(1, total // per_iter), per_iter


def _resume_counters(state) -> Tuple[int, int, int, int]:
    """``(start_iter, policy_step, last_log, last_checkpoint)``.  Only a
    checkpoint an offline run wrote continues the offline schedule: an
    online run's ``iter_num`` and ``policy_step`` count env iterations, and
    read as gradient-step counters they would put the loop past its budget.
    An online checkpoint restores the agent and optimizer state and starts
    a fresh offline budget at step 0."""
    if state and state.get("offline"):
        return state["iter_num"] + 1, state["policy_step"], state["last_log"], state["last_checkpoint"]
    return 1, 0, 0, 0


def _save_offline_checkpoint(runtime, diag, log_dir: str, state: Dict[str, Any], policy_step: int, iter_num: int,
                             preempt: bool) -> str:
    ckpt_path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_0.ckpt")
    with diag.span("checkpoint"):
        runtime.call("on_checkpoint_coupled", ckpt_path=ckpt_path, state=state, replay_buffer=None)
    diag.on_checkpoint(policy_step, ckpt_path)
    if preempt:
        diag.on_preempted(policy_step, iter_num, ckpt_path)
    return ckpt_path


def _checkpoint_due(cfg, iter_num: int, total_iters: int, policy_step: int, last_checkpoint: int,
                    preempt: bool) -> bool:
    """The online loops' rule: every ``checkpoint.every`` gradient steps,
    the last iteration with ``checkpoint.save_last``, a dry run, a pending
    preemption."""
    every = cfg.checkpoint.every
    return ((every > 0 and policy_step - last_checkpoint >= every) or bool(cfg.dry_run) or preempt
            or (iter_num == total_iters and bool(cfg.checkpoint.save_last)))


def _log(logger, aggregator, logged: List[Dict[str, float]], policy_step: int, last_log: int) -> int:
    """One metric interval: the aggregates and ``Time/sps_train`` (gradient
    steps a second of ``Time/train_time``); returns the new ``last_log``."""
    from sheeprl_tpu_torch.utils.timer import timer

    metrics = aggregator.compute()
    timers = timer.compute()
    if timers.get("Time/train_time", 0) > 0:
        metrics["Time/sps_train"] = (policy_step - last_log) / timers["Time/train_time"]
    logger.log_metrics(metrics, policy_step)
    logged.append(dict(metrics))
    aggregator.reset()
    timer.reset()
    return policy_step


# ---------------------------------------------------------------------------
# SAC / DroQ: flat transition batches


def _offline_flat(runtime, cfg) -> Dict[str, Any]:
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.player import fetch_values
    from sheeprl_tpu_torch.utils.timer import timer

    name = cfg.algo.name
    device = runtime.device
    generator = runtime.seed_everything(cfg.seed)
    logger, log_dir, diag, dataset, aggregator, offline = _open_run(runtime, cfg)

    for key in ("observations", "actions", "rewards", "terminated"):
        if key not in dataset.key_specs:
            raise ValueError(
                f"offline {name} needs the '{key}' key; the dataset at '{dataset.root}' carries {sorted(dataset.keys)}"
            )
    obs_dim = int(prod(dataset.key_specs["observations"][0]))
    act_dim = int(prod(dataset.key_specs["actions"][0]))
    mlp_keys = list(cfg.algo.mlp_keys.encoder) or ["state"]
    if len(mlp_keys) > 1:
        # the dataset stores the flat concatenation the collecting loop built:
        # one key carries it whole
        warnings.warn(
            f"offline {name}: dataset observations are pre-flattened; collapsing "
            f"algo.mlp_keys.encoder={mlp_keys} onto '{mlp_keys[0]}'",
            UserWarning,
        )
    cfg.algo.mlp_keys.encoder = mlp_keys[:1]
    obs_space = spaces.Dict({mlp_keys[0]: spaces.Box(-np.inf, np.inf, (obs_dim,), np.float32)})
    action_space = _offline_action_space(act_dim, offline)

    resume_from = cfg.checkpoint.get("resume_from")
    state = runtime.load(resume_from) if resume_from else None
    if name == "droq":
        from sheeprl_tpu_torch.algos.droq.droq import DroQFamily as family_cls
    else:
        from sheeprl_tpu_torch.algos.sac.sac import SACFamily as family_cls
    family = family_cls(cfg, obs_space, action_space, state, device).make_update()
    # one replica a shard, each with its random stream (shard 0's is the run's)
    family.shard_over(runtime.devices, generator, cfg.seed, runtime.shard_offset, runtime.world_size)
    update = diag.instrument("train_step", family.step, kind="train")
    metric_order, health_out = family.metric_order, family.health_names
    n_losses = len(metric_order)
    diag.register_footprint("params", [m for shard in family.shards for m in shard.modules()])
    diag.register_footprint("opt_state", [o for shard in family.shards for o in shard.optimizers.values()])

    total_iters, grad_per_iter = _grad_plan(cfg, offline)
    batch_rows = local_sample_size(int(cfg.algo.per_rank_batch_size) * runtime.world_size)
    train_keys = [k for k in ("observations", "next_observations", "actions", "rewards", "terminated")
                  if k in dataset.key_specs]
    derive_next = "next_observations" not in dataset.key_specs
    epoch_box = {"epoch": 0}

    def feed(seed_salt: int, keys: List[str], derive: bool):
        return dataset.batches(
            batch_rows * grad_per_iter,
            seed=int(cfg.seed) + seed_salt,
            mode="flat",
            keys=keys,
            derive_next_obs=derive,
            next_obs_keys=("observations",),
            shuffle_window=int(offline.get("shuffle_window") or (1 << 16)),
            prefetch=int(offline.get("prefetch", 2) or 0),
            on_epoch=lambda e: epoch_box.__setitem__("epoch", e),
        )

    def staged(host: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """``[G * B, ...]`` host rows -> ``[G, B, ...]`` float32 on the device:
        gradient step ``g`` trains on rows ``[g * B, (g + 1) * B)``."""
        return {k: torch.from_numpy(np.asarray(v, np.float32)).to(device).reshape(
            grad_per_iter, batch_rows, *np.asarray(v).shape[1:]) for k, v in host.items()}

    batches = feed(0, train_keys, derive_next)
    # DroQ's actor trains on a second stream of batches
    actor_batches = feed(1, ["observations"], False) if name == "droq" else None

    start_iter, policy_step_count, last_log, last_checkpoint = _resume_counters(state)
    metric_rows: List[np.ndarray] = []
    logged: List[Dict[str, float]] = []
    checkpoints: List[str] = []
    iterations = 0
    for iter_num in range(start_iter, total_iters + 1):
        iterations += 1
        with timer("Time/train_time", device):
            with diag.span("buffer-sample"):
                data = staged(next(batches))
                rows = batch_rows * grad_per_iter
                if actor_batches is not None:
                    actor_data = staged(next(actor_batches))
                    rows += batch_rows * grad_per_iter  # the second stream counts too
            data = diag.maybe_inject_nan(iter_num, data)
            with diag.span("train"):
                # each shard on its block of every gradient step's rows
                if name == "droq":
                    data["actor_observations"] = actor_data["observations"]
                metrics = update(data, generator)
                (row,) = fetch_values(metrics)
        policy_step_count += grad_per_iter
        metric_rows.append(row)
        diag.note_dataset_read(rows)
        diag.note_dataset_epoch(epoch_box["epoch"])
        if health_out:
            diag.on_health(policy_step_count, dict(zip(health_out, row[n_losses + 1:].tolist())))
        stats = dict(zip(metric_order, row[:n_losses].tolist()))
        for key, value in stats.items():
            aggregator.update(key, value)
        diag.on_update(policy_step_count, stats, nonfinite=float(row[n_losses]))

        if policy_step_count - last_log >= cfg.metric.log_every or iter_num == total_iters or cfg.dry_run:
            last_log = _log(logger, aggregator, logged, policy_step_count, last_log)

        preempt_now = diag.preempt_due(iter_num)
        if _checkpoint_due(cfg, iter_num, total_iters, policy_step_count, last_checkpoint, preempt_now):
            last_checkpoint = policy_step_count
            ckpt_state = {
                "agent": family.trees(),
                "opt_states": family.opt_states(),
                "offline": True,  # the counters below count gradient steps
                "iter_num": iter_num,
                "policy_step": policy_step_count,
                "last_log": last_log,
                "last_checkpoint": last_checkpoint,
                "batch_size": int(cfg.algo.per_rank_batch_size) * runtime.world_size,  # the global batch
            }
            checkpoints.append(_save_offline_checkpoint(runtime, diag, log_dir, ckpt_state, policy_step_count,
                                                        iter_num, preempt_now))

    logger.finalize()
    diag.close("completed")
    width = n_losses + 1 + len(health_out)
    rows = np.asarray(metric_rows, np.float32).reshape(-1, width)
    return {
        "start_iter": start_iter,
        "policy_steps": policy_step_count,
        "iterations": iterations,
        "gradient_steps": iterations * grad_per_iter,
        "metric_rows": rows[:, :n_losses],
        "nonfinite_updates": rows[:, n_losses],
        "logged": logged,
        "checkpoints": checkpoints,
        "log_dir": log_dir,
        "family": family,
        "shards": runtime.world_size,
        "replicas_equal": replicas_equal([[*shard.modules(), *shard.optimizers.values()]
                                          for shard in family.shards]),
        "dataset": dataset.summary(),
    }


# ---------------------------------------------------------------------------
# DreamerV3: sequence windows drive the whole gradient step


def _offline_dreamer(runtime, cfg) -> Dict[str, Any]:
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import (
        build_dreamer_agent,
        learner_replicas_equal,
        make_train_step,
        nest,
        shard_learner,
        stage_batch,
        target_tau,
    )
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import rssm_scan_spec
    from sheeprl_tpu_torch.diagnostics.health import mean_stats
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.interop.flax_params import optax_state
    from sheeprl_tpu_torch.models.blocks import LayerNormGRUCell
    from sheeprl_tpu_torch.utils.timer import timer

    device = runtime.device
    generator = runtime.seed_everything(cfg.seed)
    logger, log_dir, diag, dataset, aggregator, offline = _open_run(runtime, cfg)

    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    obs_keys = cnn_keys + mlp_keys
    needed = obs_keys + ["actions", "rewards", "terminated", "is_first"]
    if rssm_scan_spec(cfg)[0] > 1:
        needed += ["rssm_recurrent", "rssm_posterior", "rssm_valid"]
    missing = [k for k in needed if k not in dataset.key_specs]
    if missing:
        raise ValueError(
            f"offline dreamer_v3 needs dataset keys {missing} which '{dataset.root}' does not "
            f"carry (have {sorted(dataset.keys)}); for rssm_* keys re-collect with "
            "algo.rssm_chunks > 1 or train with algo.rssm_chunks=1"
        )

    obs_spaces = {}
    for k in obs_keys:
        shape, dtype = dataset.key_specs[k]
        if np.dtype(dtype) == np.uint8:
            obs_spaces[k] = spaces.Box(0, 255, shape, np.uint8)
        else:
            # the collecting loop stores vector keys with a trailing feature axis
            obs_spaces[k] = spaces.Box(-np.inf, np.inf, shape, np.float32)
    obs_space = spaces.Dict(obs_spaces)
    stored_act_dim = int(prod(dataset.key_specs["actions"][0]))
    actions_dim = offline.get("actions_dim")
    actions_dim = tuple(int(d) for d in actions_dim) if actions_dim else (stored_act_dim,)
    if int(sum(actions_dim)) != stored_act_dim:
        raise ValueError(
            f"algo.offline.actions_dim={list(actions_dim)} sums to {sum(actions_dim)} but the "
            f"dataset stores {stored_act_dim}-dim actions"
        )
    is_continuous = offline.get("is_continuous")
    if is_continuous is None:
        # no explicit family: an un-annotated dataset is one flat continuous
        # action vector (the exporter stores the raw action concatenation)
        is_continuous = not offline.get("actions_dim")
    is_continuous = bool(is_continuous)

    resume_from = cfg.checkpoint.get("resume_from")
    state = runtime.load(resume_from) if resume_from else None
    agent = build_dreamer_agent(actions_dim, is_continuous, cfg, obs_space, state, device)
    if device.type == "cuda" and any(isinstance(m, LayerNormGRUCell) and m.norm is not None
                                     for m in agent.world_model.modules()):
        diag.build_kernels(["ln_gru"])  # nvcc at first use, as the run state `compiling`
    for module in agent:
        module.to(runtime.param_dtype)
    # one replica a shard, as the online loop's (shard 0's is the checkpoint's)
    devices = runtime.devices
    replicas, optimizer_sets, moments_state, dp_train_step = shard_learner(
        runtime, cfg, diag, agent, state, make_train_step, is_continuous, generator)
    train_step = diag.instrument("train_step", dp_train_step, kind="train")
    optimizers = optimizer_sets[0]
    metric_order, health_out = train_step.metric_order, train_step.health_names

    total_iters, grad_per_iter = _grad_plan(cfg, offline)
    seq_len = int(offline.get("sequence_length") or cfg.algo.per_rank_sequence_length)
    batch_cols = local_sample_size(int(cfg.algo.per_rank_batch_size) * runtime.world_size)
    epoch_box = {"epoch": 0}
    batches = dataset.batches(
        batch_cols,
        seed=int(cfg.seed),
        mode="sequence",
        sequence_length=seq_len,
        keys=needed,
        respect_episodes=bool(offline.get("respect_episodes", False)),
        shuffle_window=int(offline.get("shuffle_window") or (1 << 16)),
        prefetch=int(offline.get("prefetch", 2) or 0),
        on_epoch=lambda e: epoch_box.__setitem__("epoch", e),
    )

    start_iter, policy_step_count, last_log, last_checkpoint = _resume_counters(state)
    gradient_steps = 0  # the target critic's counter: from 0 in every run
    metric_rows: List[np.ndarray] = []
    logged: List[Dict[str, float]] = []
    checkpoints: List[str] = []
    iterations = 0
    for iter_num in range(start_iter, total_iters + 1):
        iterations += 1
        pending: List[torch.Tensor] = []
        with timer("Time/train_time", device):
            for _ in range(grad_per_iter):
                with diag.span("buffer-sample"):
                    # the sequences cut into the shards' blocks (batch axis 1)
                    blocks = [stage_batch(block, cnn_keys, d)
                              for block, d in zip(split(next(batches), len(devices), 1), devices)]
                blocks = diag.maybe_inject_nan(iter_num, blocks)
                with diag.span("train"):
                    moments_state, metrics = train_step(moments_state, blocks, target_tau(cfg, gradient_steps))
                gradient_steps += 1
                pending.append(metrics)
        # the iteration's metric rows cross to the host in one copy
        rows = torch.stack(pending).cpu().numpy()
        metric_rows.extend(rows)
        policy_step_count += grad_per_iter
        diag.note_dataset_read(grad_per_iter * batch_cols * seq_len)
        diag.note_dataset_epoch(epoch_box["epoch"])
        diag.observe_rows(policy_step_count, metric_order, rows[:, :len(metric_order)])
        if health_out:
            diag.on_health(policy_step_count, mean_stats(
                [dict(zip(health_out, row[len(metric_order):])) for row in rows]))
        for row in rows:
            for key, value in zip(metric_order, row):
                if np.isfinite(value):
                    aggregator.update(key, float(value))

        if policy_step_count - last_log >= cfg.metric.log_every or iter_num == total_iters or cfg.dry_run:
            last_log = _log(logger, aggregator, logged, policy_step_count, last_log)

        preempt_now = diag.preempt_due(iter_num)
        if _checkpoint_due(cfg, iter_num, total_iters, policy_step_count, last_checkpoint, preempt_now):
            last_checkpoint = policy_step_count
            ckpt_state = {
                **agent.trees(),
                # optax's layout, so that the JAX package resumes it too
                "opt_states": nest({n: optax_state(opt, agent.optimizer_spec(n)) for n, opt in optimizers.items()}),
                "moments": moments_state,
                "offline": True,  # the counters below count gradient steps
                "iter_num": iter_num,
                "policy_step": policy_step_count,
                "batch_size": int(cfg.algo.per_rank_batch_size) * runtime.world_size,  # the global batch
                "last_log": last_log,
                "last_checkpoint": last_checkpoint,
            }
            checkpoints.append(_save_offline_checkpoint(runtime, diag, log_dir, ckpt_state, policy_step_count,
                                                        iter_num, preempt_now))

    logger.finalize()
    diag.close("completed")
    rows = np.asarray(metric_rows, np.float32).reshape(-1, len(metric_order) + len(health_out))
    return {
        "start_iter": start_iter,
        "policy_steps": policy_step_count,
        "iterations": iterations,
        "gradient_steps": gradient_steps,
        "metric_order": metric_order,
        "metric_rows": rows[:, :len(metric_order)],
        "health_rows": {name: rows[:, len(metric_order) + i] for i, name in enumerate(health_out)},
        "shards": runtime.world_size,
        "replicas_equal": learner_replicas_equal(replicas, optimizer_sets),
        "logged": logged,
        "checkpoints": checkpoints,
        "log_dir": log_dir,
        "dataset": dataset.summary(),
    }
