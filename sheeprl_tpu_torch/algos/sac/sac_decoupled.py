"""Decoupled SAC (counterpart of ``sheeprl_tpu/algos/sac/sac_decoupled.py``):
one player with the replay buffer and a trainer of one or more shards.

The topology is decoupled PPO's (``algos/ppo/ppo_decoupled.py``): device 0
of the data axis is the player, which holds the replay buffer and an actor
of its own; devices 1..N-1 are the trainer's shards, each with a replica of
SAC's actor, critics, target critics, ``log_alpha`` and their three
optimizers (:class:`~sheeprl_tpu_torch.algos.sac.sac.SACFamily`).  Each
train call samples ``per_rank_batch_size`` rows a trainer shard for every
gradient step and cuts the ``[G, B, ...]`` batch over the shards along its
batch axis (axis 1, the JAX ``P(None, "data")``).  The gradient steps run
while the envs step, on the transitions through the previous step (after
the write when the buffer was still empty), as SAC's coupled loop runs
them.  Only the actor is handed to the player, through the promotion gate;
the quarantine covers the train dispatch, not the sampling.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.ppo_decoupled import check_topology, promote, restore_trainer, trainer_state
from sheeprl_tpu_torch.algos.sac.sac import SACFamily
from sheeprl_tpu_torch.algos.sac.utils import prepare_obs, test
from sheeprl_tpu_torch.parallel.dp import local_sample_size, replicas_equal, shard_generators
from sheeprl_tpu_torch.utils.registry import register_algorithm

#: the sampled keys the gradient steps read
TRAIN_KEYS = ("observations", "next_observations", "actions", "rewards", "terminated")


@register_algorithm(decoupled=True)
def main(runtime, cfg) -> Dict[str, Any]:
    """The decoupled SAC loop, as the JAX loop runs it: per iteration one
    policy step of every env by the player (uniform random actions until
    ``algo.learning_starts``), the gradient steps ``Ratio`` owes on the
    trainer shards overlapping the env step, the transition into the
    player's replay buffer, logging and checkpoints (the trainer's state,
    the Ratio and the replay; under a fence halt the last-good state), and
    one greedy test episode with the player's actor.  Returns what the run
    did, the player's gate verdicts and hand-off times included."""
    from sheeprl_tpu_torch.config import instantiate
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer
    from sheeprl_tpu_torch.data.slab import step_slab
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.env import make_env, make_env_fns, pipelined_vector_env
    from sheeprl_tpu_torch.envs.player import ObsStager, fetch_values
    from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
    from sheeprl_tpu_torch.utils.timer import timer
    from sheeprl_tpu_torch.utils.utils import Ratio, get_diagnostics, save_configs

    n_trainers = check_topology(runtime.world_size, "SAC")
    player_device, trainer_devices = runtime.devices[0], runtime.devices[1:]
    num_envs = int(cfg.env.num_envs)

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
    if not isinstance(action_space, spaces.Box):
        raise ValueError("SAC supports only continuous (Box) action spaces")
    mlp_keys = list(cfg.algo.mlp_keys.encoder)

    resume_from = cfg.checkpoint.get("resume_from")
    state = runtime.load(resume_from) if resume_from else None
    # the trainer: a replica of the agent and its optimizers a trainer shard
    # (shard 0's is checkpointed), drawing its noise from its own stream
    family = SACFamily(cfg, observation_space, action_space, state, trainer_devices[0]).make_update()
    family.stager = ObsStager(trainer_devices[0])
    trainer_generator = shard_generators(generator, cfg.seed, runtime.devices)[1]
    family.shard_over(trainer_devices, trainer_generator, cfg.seed)
    trainer_shards = [(shard.modules(), shard.optimizers) for shard in family.shards]
    train_step = diag.instrument("train_step", family.step, kind="train")
    metric_order, health_out = family.metric_order, family.health_names
    n_losses = len(metric_order)
    # the player: an actor of its own on device 0
    player_actor = copy.deepcopy(family.agent.actor).to(player_device).eval()
    for p in player_actor.parameters():
        p.requires_grad_(False)
    player_stager = ObsStager(player_device)
    act_dim = int(np.prod(action_space.shape))

    @torch.no_grad()
    def act(obs: Dict[str, np.ndarray]) -> torch.Tensor:
        flat = prepare_obs(obs, player_stager, mlp_keys, num_envs)
        eps = torch.randn((num_envs, act_dim), generator=generator, device=player_device)
        return player_actor.sample_and_log_prob(flat, eps)[0]

    policy_step = diag.instrument("policy_step", act, kind="rollout")
    diag.register_footprint("params", [m for shard in family.shards for m in shard.modules()])
    diag.register_footprint("opt_state", [o for shard in family.shards for o in shard.optimizers.values()])
    diag.register_footprint("player_params", player_actor)

    rb = ReplayBuffer(cfg.buffer.size, num_envs, memmap=cfg.buffer.memmap,
                      memmap_dir=os.path.join(log_dir, "memmap_buffer"), obs_keys=family.obs_keys())
    rb.seed(cfg.seed)
    diag.track_buffer("replay", rb)
    if state and state.get("rb") is not None:
        rb.load_state_dict(state["rb"])

    start_iter = (state["iter_num"] if state else 0) + 1
    policy_step_count = state["policy_step"] if state else 0
    last_log = state["last_log"] if state else 0
    last_checkpoint = state["last_checkpoint"] if state else 0
    policy_steps_per_iter = num_envs
    total_iters = int(cfg.algo.total_steps // policy_steps_per_iter) if not cfg.dry_run else 1
    learning_starts = int(cfg.algo.learning_starts // policy_steps_per_iter) if not cfg.dry_run else 0
    prefill_steps = learning_starts - int(learning_starts > 0)
    if resume_from:
        learning_starts += start_iter
        prefill_steps += start_iter
    ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)
    if state and "ratio" in state:
        ratio.load_state_dict(state["ratio"])
    batch_size = int(cfg.algo.per_rank_batch_size)
    action_rng = np.random.default_rng(cfg.seed)
    obs = envs.reset(seed=cfg.seed)[0]

    metric_rows: List[np.ndarray] = []
    logged: List[Dict[str, float]] = []
    checkpoints: List[str] = []
    gate: List[tuple] = []
    handoff_ms: List[float] = []
    rollbacks: List[int] = []
    gradient_steps_done = 0

    def quarantined(err: Exception, iter_num: int) -> None:
        restored = diag.quarantine(err, iter_num, policy_step_count)
        if restored is None:
            raise err
        restore_trainer(trainer_shards, restored)
        rollbacks.append(iter_num)

    def run_train(iter_num: int, gradient_steps: int) -> None:
        """Sample this iteration's gradient steps' batches on the player,
        cut them over the trainer shards and dispatch them there, then the
        gate, the hand-off of the actor and the metrics."""
        nonlocal gradient_steps_done
        with timer("Time/train_time", trainer_devices[0]):
            with diag.span("buffer-sample"):
                sample = rb.sample(batch_size=local_sample_size(batch_size * n_trainers), n_samples=gradient_steps,
                                   sample_next_obs=family.sample_next_obs())
                data = family.stager({k: np.asarray(sample[k], np.float32) for k in TRAIN_KEYS})
            data = diag.maybe_inject_nan(iter_num, data)
            # quarantined: the dispatch only (a sampling failure is no train
            # step incident and spends no rollback)
            try:
                with diag.span("train", role="trainer"):
                    diag.maybe_chaos_trainer_fault(iter_num)
                    metrics = train_step(data, trainer_generator)
                    (row,) = fetch_values(metrics)  # the one fetch of the call's metrics
            except Exception as err:
                quarantined(err, iter_num)
                return
        gradient_steps_done += gradient_steps
        metric_rows.append(row)
        losses = dict(zip(metric_order, row[:n_losses].tolist()))
        health = dict(zip(health_out, row[n_losses + 1:].tolist()))
        nonfinite = float(row[n_losses])
        promoted = diag.gate_promotion(iter_num, policy_step_count, stats=health, nonfinite=nonfinite)
        gate.append((iter_num, bool(promoted)))
        if promoted:
            handoff_ms.append(promote(player_actor, family.agent.actor))
            diag.refresh_last_good(iter_num, **trainer_state(family.modules(), family.optimizers))
        if health:
            diag.on_health(policy_step_count, health)
        for name, value in losses.items():
            aggregator.update(name, value)
        try:
            diag.on_update(policy_step_count, losses, nonfinite=nonfinite)
        except Exception as err:
            # a halting sentinel on a fenced update: the trainer rolls back
            # and the run goes on (the gate kept it from the player)
            quarantined(err, iter_num)

    iterations = 0
    for iter_num in range(start_iter, total_iters + 1):
        iterations += 1
        policy_step_count += policy_steps_per_iter
        diag.note_env_steps(num_envs)
        with timer("Time/env_interaction_time"), diag.span("rollout", role="player"):
            if iter_num <= learning_starts:
                actions = envs.sample_actions(action_rng).astype(np.float32)
            else:
                (actions,) = fetch_values(policy_step(obs))
            with diag.span("env_step_async"):
                envs.step_async(actions.reshape(envs.batched_action_shape))

        # the trainer's gradient steps overlap the env step (the buffer's
        # transitions through the previous step; after the write below when
        # it is still empty)
        gradient_steps, trained = 0, False
        if iter_num >= learning_starts:
            gradient_steps = ratio(policy_step_count - prefill_steps * policy_steps_per_iter)
            if cfg.dry_run:
                gradient_steps = 1
            if gradient_steps > 0 and not rb.empty:
                run_train(iter_num, gradient_steps)
                trained = True

        with timer("Time/env_interaction_time"), diag.span("env_wait"):
            next_obs, rewards, terminated, truncated, info = envs.step_wait()
        rewards = np.asarray(rewards, dtype=np.float32).reshape(num_envs, -1)
        if "final_info" in info and "episode" in info["final_info"]:
            ep = info["final_info"]["episode"]
            mask = ep.get("_r", info["final_info"].get("_episode"))
            if mask is not None and np.any(mask):
                for r, length in zip(ep["r"][mask], ep["l"][mask]):
                    aggregator.update("Rewards/rew_avg", float(r))
                    aggregator.update("Game/ep_len_avg", float(length))
        # a finished episode's real last observation, not the reset's
        real_next_obs = {k: np.asarray(next_obs[k]).copy() for k in mlp_keys}
        if "final_obs" in info:
            for idx, final_obs in enumerate(info["final_obs"]):
                if final_obs is not None:
                    for k in mlp_keys:
                        real_next_obs[k][idx] = np.asarray(final_obs[k])
        step = {**family.record(obs, real_next_obs, actions, num_envs), "actions": actions.reshape(num_envs, -1),
                "rewards": rewards, "terminated": terminated, "truncated": truncated}
        rb.add(step_slab(num_envs, step, dtypes={"terminated": np.float32, "truncated": np.float32}),
               validate_args=cfg.buffer.validate_args)
        obs = next_obs
        if gradient_steps > 0 and not trained:
            run_train(iter_num, gradient_steps)

        if policy_step_count - last_log >= cfg.metric.log_every or iter_num == total_iters or cfg.dry_run:
            metrics_dict = aggregator.compute()
            timers = timer.compute()
            if timers.get("Time/env_interaction_time", 0) > 0:
                metrics_dict["Time/sps_env_interaction"] = (
                    (policy_step_count - last_log) / timers["Time/env_interaction_time"])
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
                # the last-good state, with the counters of its iteration
                # (the run ends here: the trainer takes it back to be saved)
                last_good = diag.last_good_state()
                if last_good is not None:
                    restore_trainer(trainer_shards, last_good)
                    ckpt_iter = last_good["iter_num"]
                    ckpt_step = ckpt_iter * policy_steps_per_iter
            ckpt_state = {
                "agent": family.trees(),
                # optax's layout, so that the JAX package resumes it too
                "opt_states": family.opt_states(),
                "ratio": ratio.state_dict(),
                "iter_num": ckpt_iter,
                "policy_step": ckpt_step,
                "last_log": min(last_log, ckpt_step),
                "last_checkpoint": min(last_checkpoint, ckpt_step),
                "batch_size": batch_size * n_trainers,
            }
            ckpt_path = os.path.join(log_dir, "checkpoint", f"ckpt_{ckpt_step}_0.ckpt")
            with diag.span("checkpoint"):
                runtime.call("on_checkpoint_player", ckpt_path=ckpt_path, state=ckpt_state,
                             replay_buffer=rb if cfg.buffer.checkpoint else None)
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
        test_reward = test(player_actor, make_env(cfg, cfg.seed, 0, log_dir, "test")(), cfg, player_device,
                           player_stager)
        logger.log_metrics({"Test/cumulative_reward": test_reward}, policy_step_count)
    logger.finalize()
    diag.close("completed")
    width = n_losses + 1 + len(health_out)
    rows = np.asarray(metric_rows, np.float32).reshape(-1, width) if metric_rows else np.zeros((0, width), np.float32)
    return {
        "start_iter": start_iter,
        "policy_steps": policy_step_count,
        "iterations": iterations,
        "gradient_steps": gradient_steps_done,
        "shards": runtime.world_size,
        "trainer_shards": n_trainers,
        # every trainer replica holds shard 0's bytes (parameters, optimizer state)
        "replicas_equal": replicas_equal([[*modules, optimizers] for modules, optimizers in trainer_shards]),
        "test_reward": test_reward,
        "metric_rows": rows[:, :n_losses],
        "nonfinite_updates": rows[:, n_losses],
        "health_rows": {name: rows[:, n_losses + 1 + i] for i, name in enumerate(health_out)},
        "gate": gate,
        "handoff_ms": handoff_ms,
        "rollbacks": rollbacks,
        "player": player_actor,
        "trainer": trainer_shards,
        "family": family,
        "logged": logged,
        "checkpoints": checkpoints,
        "log_dir": log_dir,
    }
