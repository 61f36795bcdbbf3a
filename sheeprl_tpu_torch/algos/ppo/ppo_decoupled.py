"""Decoupled PPO (counterpart of ``sheeprl_tpu/algos/ppo/ppo_decoupled.py``):
one player and a trainer of one or more shards.

Device 0 of the data axis (``runtime.devices``) is the player, devices
1..N-1 the trainer's shards.  The player acts with an agent of its own (a
deep copy, never a trainer replica: on one card every shard is ``cuda:0``
and the trainer's shard 0 would otherwise be the same module), rolls out,
and computes GAE with its own value head.  The rollout's rows are cut into
one block a trainer shard (the JAX loop's ``device_put`` over the trainer
sub-mesh); each trainer shard holds a replica of the agent and its Adam
optimizer and runs PPO's update on its block, the shards in lockstep
(``parallel/dp.py::run_shards``), so the replicas stay bitwise equal.

Fault isolation (``diagnostics.resilience.isolation``): the update's
parameters are handed to the player (:func:`promote`) only when the
promotion gate judges the update healthy; a healthy promotion refreshes the
last-good host copy of the trainer's parameters and optimizer state.  A
train-step failure (a chaos ``trainer_exception``, or a halting sentinel
on a fenced update) restores every trainer replica from that copy in place
(Adam's moments and step counts, and so the learning-rate schedule's
count, included) and the run goes on; past the staleness budget the run
saves the last-good state with the counters of its iteration and halts.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Any, Dict, List

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.agent import actions_dim_of, build_agent
from sheeprl_tpu_torch.algos.ppo.ppo import OnPolicyFamily, make_update, rollout, rollout_data
from sheeprl_tpu_torch.parallel.dp import copy_state_, replicas_equal, run_shards, shard_generators, state_tensors
from sheeprl_tpu_torch.parallel.mesh import replicate
from sheeprl_tpu_torch.utils.registry import register_algorithm


def promote(player: torch.nn.Module, trainer: torch.nn.Module) -> float:
    """The trainer-to-player hand-off: the trainer's shard-0 replica's
    parameters and buffers copied into the player's own agent in place (the
    JAX loop's ``device_put`` of the params onto the player device).
    Returns its wall time in ms, the copy waited for."""
    t0 = time.perf_counter()
    copy_state_(player, trainer)
    for device in {t.device for t in state_tensors(player)}:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3


def trainer_state(modules: Any, optimizers: Any) -> Dict[str, List[torch.Tensor]]:
    """The trainer's shard-0 state as the isolation layer keeps it:
    ``params`` (every parameter and buffer) and ``opt_state`` (every
    optimizer state tensor), in :func:`~sheeprl_tpu_torch.parallel.dp.state_tensors`' order."""
    return {"params": state_tensors(modules), "opt_state": state_tensors(optimizers)}


def restore_trainer(shards: List[Any], restored: Dict[str, Any]) -> None:
    """Every trainer shard's ``(modules, optimizers)`` restored in place,
    bitwise, from the last-good host copy (``restored``, what
    ``Diagnostics.quarantine`` returns), gradients dropped: a failure inside
    the update may have stepped some replicas and not others."""
    for modules, optimizers in shards:
        copy_state_(modules, restored["params"])
        copy_state_(optimizers, restored["opt_state"])
        for module in (modules if isinstance(modules, (list, tuple)) else [modules]):
            for p in module.parameters():
                p.grad = None


def check_topology(world_size: int, name: str = "PPO") -> int:
    """The JAX loop's checks of the player/trainer layout; returns the
    number of trainer shards."""
    if world_size < 2:
        raise RuntimeError(
            f"Decoupled {name} needs at least 2 devices: 1 player + >=1 trainer (got fabric.devices={world_size})"
        )
    return world_size - 1


@register_algorithm(decoupled=True)
def main(runtime, cfg) -> Dict[str, Any]:
    """The decoupled PPO loop, as the JAX loop runs it: per iteration the
    player's rollout (span ``rollout``, role ``player``), GAE on the
    player's parameters, the rollout cut over the trainer shards, their
    update (span ``train``, role ``trainer``) under quarantine, the
    promotion gate and the hand-off, logging, checkpoints (the trainer's
    state; under a fence halt the last-good state), and one greedy test
    episode on the player's parameters.  Returns what the run did: the
    coupled loop's counters and rows, and the player's: each iteration's
    gate verdict, the hand-offs' ms and the player itself."""
    from sheeprl_tpu_torch.config import instantiate
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.env import make_env, make_env_fns, pipelined_vector_env
    from sheeprl_tpu_torch.envs.player import ObsStager, fetch_values, host_obs_slab
    from sheeprl_tpu_torch.interop.flax_params import optax_state, optimizer_state_dict
    from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
    from sheeprl_tpu_torch.utils.timer import timer
    from sheeprl_tpu_torch.utils.utils import get_diagnostics, save_configs

    n_trainers = check_topology(runtime.world_size)
    player_device, trainer_devices = runtime.devices[0], runtime.devices[1:]
    num_envs, rollout_steps = int(cfg.env.num_envs), int(cfg.algo.rollout_steps)
    batch_size = int(cfg.algo.per_rank_batch_size)
    total_local = rollout_steps * num_envs
    if total_local % n_trainers != 0:
        raise ValueError(
            f"rollout_steps*num_envs ({total_local}) must be divisible by the number of trainers ({n_trainers})")
    n_per_trainer = total_local // n_trainers
    if n_per_trainer % batch_size != 0:
        raise ValueError(
            f"Per-trainer rollout ({n_per_trainer}) must be divisible by per_rank_batch_size ({batch_size})")
    family = OnPolicyFamily()

    generator = runtime.seed_everything(cfg.seed)
    logger = get_logger(runtime, cfg)
    log_dir = get_log_dir(runtime, cfg.root_dir, cfg.run_name)
    save_configs(cfg, log_dir)
    logger.log_hyperparams(cfg.as_dict())
    diag = get_diagnostics(runtime, cfg, log_dir)
    aggregator = instantiate(cfg.metric.aggregator)
    if cfg.metric.log_level == 0:
        aggregator.disabled = True
    timer.disabled = cfg.metric.log_level == 0 or bool(cfg.metric.get("disable_timer", False))
    timer.reset()

    envs = pipelined_vector_env(cfg, make_env_fns(cfg, log_dir, "train"))
    observation_space, action_space = envs.single_observation_space, envs.single_action_space
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
    actions_dim, is_continuous, is_multidiscrete = actions_dim_of(action_space)

    resume_from = cfg.checkpoint.get("resume_from")
    state = runtime.load(resume_from) if resume_from else None
    agent = build_agent(actions_dim, is_continuous, cfg, observation_space, state["agent"] if state else None,
                        trainer_devices[0])
    agent.to(runtime.param_dtype)
    policy_steps_per_iter = total_local
    total_iters = int(cfg.algo.total_steps // policy_steps_per_iter) if not cfg.dry_run else 1
    clip = bool(cfg.algo.max_grad_norm and cfg.algo.max_grad_norm > 0)
    # the trainer: one replica and optimizer a trainer shard (shard 0's is
    # checkpointed); the player: an agent of its own on device 0
    replicas = replicate(agent, trainer_devices)
    optimizers = [instantiate(cfg.algo.optimizer)(replica.parameters()) for replica in replicas]
    if state and "opt_state" in state:
        for replica, opt in zip(replicas, optimizers):
            opt.load_state_dict(optimizer_state_dict(state["opt_state"], opt, family.spec(replica)))
    player = copy.deepcopy(agent).to(player_device).eval()
    for p in player.parameters():
        p.requires_grad_(False)
    updates = [make_update(replica, opt, cfg, total_iters, world_size=n_trainers)
               for replica, opt in zip(replicas, optimizers)]
    # the player draws from the run's generator; trainer shard i (device
    # i + 1 of the axis) from its own folded stream
    trainer_generators = shard_generators(generator, cfg.seed, runtime.devices)[1:]
    trainer_shards = list(zip(replicas, optimizers))

    def dp_update(iter_num: int, data: Dict[str, Any]) -> torch.Tensor:
        """The update over the trainer shards, each on its block of
        ``data``; shard 0's metrics (reduced over the shards)."""
        blocks = family.shard(data, trainer_devices)
        return run_shards([u.body(iter_num, block, g) for u, block, g in zip(updates, blocks, trainer_generators)])[0]

    for attr in ("metric_order", "health_names", "updates_per_iteration", "schedule"):
        setattr(dp_update, attr, getattr(updates[0], attr))
    train_step = diag.instrument("train_step", dp_update, kind="train")
    metric_order, health_out = train_step.metric_order, train_step.health_names
    n_losses = len(metric_order)
    policy = diag.instrument("policy_step", player, kind="rollout")
    diag.register_footprint("params", replicas)
    diag.register_footprint("opt_state", optimizers)
    diag.register_footprint("player_params", player)

    rb = ReplayBuffer(cfg.buffer.size, num_envs, memmap=cfg.buffer.memmap,
                      memmap_dir=os.path.join(log_dir, "memmap_buffer"))
    diag.track_buffer("replay", rb)

    start_iter = (state["iter_num"] if state else 0) + 1
    policy_step_count = state["policy_step"] if state else 0
    last_log = state["last_log"] if state else 0
    last_checkpoint = state["last_checkpoint"] if state else 0
    stager = ObsStager(player_device)

    def stage(host_obs: Dict[str, np.ndarray], n: int) -> Dict[str, torch.Tensor]:
        return stager(host_obs_slab(host_obs, cnn_keys, mlp_keys, n))

    obs = envs.reset(seed=cfg.seed)[0]
    metric_rows: List[np.ndarray] = []
    logged: List[Dict[str, float]] = []
    checkpoints: List[str] = []
    gate: List[tuple] = []
    handoff_ms: List[float] = []
    rollbacks: List[int] = []
    for iter_num in range(start_iter, total_iters + 1):
        # ---- the player: rollout and GAE on its own parameters ----------
        with timer("Time/env_interaction_time"), diag.span("rollout", role="player"), torch.no_grad():
            obs = rollout(policy, envs, obs, rb, stage, cfg, generator, aggregator, diag,
                          (is_continuous, is_multidiscrete))
        policy_step_count += total_local
        data = rollout_data(player, rb, obs, stage, cfg, player_device)
        # ---- the "scatter": the rows cut over the trainer shards ---------
        data = diag.maybe_inject_nan(iter_num, data)
        data = diag.maybe_inject_shape_change(iter_num, data, pad=n_trainers)

        # ---- the trainer, quarantined: a failure rolls it back ----------
        for replica in replicas:
            replica.train()
        trained_ok = True
        try:
            with timer("Time/train_time", trainer_devices[0]), diag.span("train", role="trainer"):
                diag.maybe_chaos_trainer_fault(iter_num)
                metrics = train_step(iter_num, data)
                (row,) = fetch_values(metrics)  # the iteration's one fetch of the update's results
        except Exception as err:
            restored = diag.quarantine(err, iter_num, policy_step_count)
            if restored is None:
                raise
            restore_trainer(trainer_shards, restored)
            rollbacks.append(iter_num)
            trained_ok = False

        if trained_ok:
            metric_rows.append(row)
            losses = dict(zip(metric_order, row[:n_losses].tolist()))
            health = dict(zip(health_out, row[n_losses + 1:].tolist()))
            nonfinite = float(row[n_losses])
            # ---- the promotion gate: a rejected update never reaches the
            # player, which keeps acting on its last-good parameters
            promoted = diag.gate_promotion(iter_num, policy_step_count, stats=health, nonfinite=nonfinite)
            gate.append((iter_num, bool(promoted)))
            if promoted:
                handoff_ms.append(promote(player, replicas[0]))
                diag.refresh_last_good(iter_num, **trainer_state(replicas[0], optimizers[0]))
            if health:
                diag.on_health(policy_step_count, health)
            for name, value in losses.items():
                aggregator.update(name, value)
            try:
                diag.on_update(policy_step_count, losses, nonfinite=nonfinite)
            except Exception as err:
                # a halting sentinel on a fenced update: the trainer rolls
                # back and the run goes on (the gate kept it from the player)
                restored = diag.quarantine(err, iter_num, policy_step_count)
                if restored is None:
                    raise
                restore_trainer(trainer_shards, restored)
                rollbacks.append(iter_num)

        if policy_step_count - last_log >= cfg.metric.log_every or iter_num == total_iters or cfg.dry_run:
            metrics_dict = aggregator.compute()
            timers = timer.compute()
            if timers.get("Time/env_interaction_time", 0) > 0:
                metrics_dict["Time/sps_env_interaction"] = (
                    (policy_step_count - last_log) / timers["Time/env_interaction_time"])
            if timers.get("Time/train_time", 0) > 0:
                metrics_dict["Time/sps_train"] = (
                    (iter_num * train_step.updates_per_iteration) / timers["Time/train_time"])
            logger.log_metrics(metrics_dict, policy_step_count)
            logged.append(dict(metrics_dict))
            aggregator.reset()
            timer.reset()
            last_log = policy_step_count

        # a pending preemption or an exhausted staleness budget forces the
        # branch: this save is the emergency snapshot
        preempt_now = diag.preempt_due(iter_num)
        fence_halt_now = diag.fence_halt_due()
        if (
            (cfg.checkpoint.every > 0 and policy_step_count - last_checkpoint >= cfg.checkpoint.every)
            or cfg.dry_run
            or preempt_now
            or fence_halt_now
            or (iter_num == total_iters and cfg.checkpoint.save_last)
        ):
            last_checkpoint = policy_step_count
            ckpt_iter, ckpt_step = iter_num, policy_step_count
            if fence_halt_now:
                # the fence escalated because the live trainer state is bad:
                # the snapshot is the last-good state, with the counters of
                # the iteration it came from (the run ends here, so the
                # trainer itself takes it back to be saved)
                last_good = diag.last_good_state()
                if last_good is not None:
                    restore_trainer(trainer_shards, last_good)
                    ckpt_iter = last_good["iter_num"]
                    ckpt_step = ckpt_iter * policy_steps_per_iter
            ckpt_state = {
                "agent": family.to_flax(replicas[0]),
                # optax's layout, so that the JAX package resumes it too
                "opt_state": optax_state(optimizers[0], family.spec(replicas[0]), clip=clip,
                                         schedule=train_step.schedule),
                "iter_num": ckpt_iter,
                "policy_step": ckpt_step,
                "last_log": min(last_log, ckpt_step),
                "last_checkpoint": min(last_checkpoint, ckpt_step),
                "batch_size": batch_size * n_trainers,
            }
            ckpt_path = os.path.join(log_dir, "checkpoint", f"ckpt_{ckpt_step}_0.ckpt")
            with diag.span("checkpoint"):
                runtime.call("on_checkpoint_player", ckpt_path=ckpt_path, state=ckpt_state, replay_buffer=None)
            diag.on_checkpoint(policy_step_count, ckpt_path)
            checkpoints.append(ckpt_path)
            if preempt_now:
                envs.close()
                diag.on_preempted(policy_step_count, iter_num, ckpt_path)
            if fence_halt_now:
                envs.close()
                diag.on_fence_halt(policy_step_count, iter_num, ckpt_path)

    envs.close()
    test_reward = None
    if cfg.algo.run_test:
        test_reward = family.test(player, make_env(cfg, cfg.seed, 0, log_dir, "test")(), cfg, player_device, stager)
        logger.log_metrics({"Test/cumulative_reward": test_reward}, policy_step_count)
    logger.finalize()
    diag.close("completed")
    rows = np.asarray(metric_rows, np.float32).reshape(-1, n_losses + 1 + len(health_out))
    return {
        "start_iter": start_iter,
        "policy_steps": policy_step_count,
        "iterations": max(0, total_iters - start_iter + 1),
        "shards": runtime.world_size,
        "trainer_shards": n_trainers,
        # every trainer replica holds shard 0's bytes (parameters, optimizer state)
        "replicas_equal": replicas_equal([[r, o] for r, o in trainer_shards]),
        "updates_per_iteration": train_step.updates_per_iteration,
        "test_reward": test_reward,
        "metric_rows": rows[:, :n_losses],
        "nonfinite_updates": rows[:, n_losses],
        "health_rows": {name: rows[:, n_losses + 1 + i] for i, name in enumerate(health_out)},
        "gate": gate,
        "handoff_ms": handoff_ms,
        "rollbacks": rollbacks,
        "player": player,
        "trainer": trainer_shards,
        "logged": logged,
        "checkpoints": checkpoints,
        "log_dir": log_dir,
    }
