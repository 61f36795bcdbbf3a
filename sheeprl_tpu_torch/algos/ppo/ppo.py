"""PPO training (counterpart of ``sheeprl_tpu/algos/ppo/ppo.py``): the
update phase and the loop of rollouts, GAE, logging and checkpoints.

The update follows the JAX package's ``make_train_step``: for each of
``algo.update_epochs`` epochs a permutation of the rollout's rows, cut into
minibatches of ``algo.per_rank_batch_size``; per minibatch the clipped
policy loss, the value loss (clipped with ``algo.clip_vloss``) and the
entropy bonus (the agent's parameters and the observations cast to the
compute dtype of ``fabric.precision``, as the JAX loss casts them), the
gradient, clipping by global norm
(``algo.max_grad_norm > 0``) and one Adam step, whose learning rate with
``algo.anneal_lr`` is optax's ``linear_schedule`` at the update count
before the step.  The metric vector ``[policy, value, entropy, grad norm]``
is the mean over the minibatches, and a fifth entry counts the non-finite
ones.  Under ``diagnostics`` (the default) the update also computes the
train-health stats, the value function's explained variance over the
rollout, and with ``sentinel.policy=skip_update`` discards a non-finite
minibatch step on the device.  Everything stays on the device until the
loop fetches it once per iteration.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent, actions_dim_of, build_agent
from sheeprl_tpu_torch.algos.ppo.loss import entropy_loss, policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.utils import env_actions_of, test
from sheeprl_tpu_torch.diagnostics.health import health_names, health_spec, health_stats, unit_dim
from sheeprl_tpu_torch.diagnostics.sentinel import finite_flag, select_finite, sentinel_spec, skip_update_guard
from sheeprl_tpu_torch.parallel.precision import call_cast, cast_floating, compute_dtype_of
from sheeprl_tpu_torch.utils.optim import clip_by_global_norm, global_norm
from sheeprl_tpu_torch.utils.registry import register_algorithm

METRIC_ORDER = ["Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss", "Grads/global_norm"]


def linear_schedule(init_value: float, end_value: float, transition_steps: int):
    """optax's ``linear_schedule``, in float32 as optax evaluates it."""
    init, end, steps = np.float32(init_value), np.float32(end_value), int(transition_steps)

    def schedule(count):
        if isinstance(count, torch.Tensor):
            frac = 1.0 - count.float().clamp(0, steps) / steps
            return float(init - end) * frac + float(end)
        frac = np.float32(1.0) - np.float32(min(max(int(count), 0), steps)) / np.float32(steps)
        return float((init - end) * frac + end)

    return schedule


def lr_setter(optimizer: torch.optim.Optimizer, schedule) -> Callable[[], None]:
    """``set_lr()``: the optimizer's rate at ``schedule`` of its update
    count, called before each step.  optax evaluates the schedule at the
    count before the update: the first update runs at the initial rate.
    Adam's step is that count; a capturable Adam keeps it on the device,
    and the rate follows it there (a skipped update does not advance it)."""
    group0 = optimizer.param_groups[0]
    first = group0["params"][0]

    def set_lr() -> None:
        step = optimizer.state[first].get("step") if optimizer.state.get(first) else None
        if step is not None and step.device.type != "cpu":
            rate = schedule(step)
            if isinstance(group0["lr"], torch.Tensor):
                group0["lr"].copy_(rate)
            else:
                group0["lr"] = rate.clone()
        else:
            group0["lr"] = schedule(0 if step is None else int(step))

    return set_lr


def _module_groups(agent: PPOAgent):
    """The agent's parameters by the top-level module of the flax tree (the
    health stats' modules), each with its unit axes."""
    from sheeprl_tpu_torch.interop.flax_params import ppo_spec

    groups: Dict[str, List[torch.Tensor]] = {}
    dims: Dict[str, List[int]] = {}

    def walk(name: str, node: Any) -> None:
        if isinstance(node, dict):
            for sub in node.values():
                walk(name, sub)
        else:
            groups.setdefault(name, []).append(node[0])
            dims.setdefault(name, []).append(unit_dim(node[1], node[0].dim()))

    for name, node in ppo_spec(agent)["params"].items():
        walk(name, node)
    return groups, dims


def make_train_step(agent: PPOAgent, optimizer: torch.optim.Optimizer, cfg, num_minibatches: int, batch_size: int,
                    schedule=None):
    """Build the update phase: ``update(data, perms, coefs) -> metrics``.

    ``data`` holds ``obs`` (a dict), ``actions``, ``logprobs``, ``values``,
    ``returns`` and ``advantages``, ``[N, ...]`` tensors on the device,
    ``N = num_minibatches * batch_size``; ``perms`` the ``update_epochs``
    permutations of ``range(N)`` (drawn by the loop, injected by tests);
    ``coefs`` the ``(clip, entropy, value)`` coefficients.  The agent and
    the optimizer update in place.  ``metrics`` is one float32 vector:
    the four ``METRIC_ORDER`` means, the non-finite minibatch count, then
    the health stats (``update.health_names``) averaged over the minibatches
    and ``value_ev`` (the rollout's values against its returns)."""
    sentinel, health = sentinel_spec(cfg), health_spec(cfg)
    cdt = compute_dtype_of(cfg)
    epochs = int(cfg.algo.update_epochs)
    max_grad_norm = float(cfg.algo.max_grad_norm or 0.0)
    reduction = cfg.algo.loss_reduction
    params = [p for group in optimizer.param_groups for p in group["params"]]
    if health.enabled:
        groups, unit_dims = _module_groups(agent)
        names = list(groups)
        health_out = health_names(names, health.per_module) + ["value_ev"]
        before = {n: [torch.empty_like(p) for p in groups[n]] for n in names}
        index = {id(p): i for i, p in enumerate(params)}
    else:
        health_out = []
    if sentinel.skip_update:
        guarded, snapshot = skip_update_guard([agent], [optimizer])
    first = params[0]
    set_lr = lr_setter(optimizer, schedule)

    def loss_fn(mb: Dict[str, Any], clip_coef: float, ent_coef: float, vf_coef: float):
        # the parameters and observations in the compute dtype, as the JAX
        # loss casts them; the loss math in fp32
        _, new_logprobs, entropy, new_values = call_cast(
            (agent,), cdt, lambda: agent(cast_floating(mb["obs"], cdt), actions=mb["actions"]))
        advantages = mb["advantages"]
        if cfg.algo.normalize_advantages:
            advantages = (advantages - advantages.mean()) / (advantages.std(unbiased=False) + 1e-8)
        pg = policy_loss(new_logprobs, mb["logprobs"], advantages, clip_coef, reduction)
        v = value_loss(new_values.float(), mb["values"], mb["returns"], clip_coef, cfg.algo.clip_vloss, reduction)
        e = entropy_loss(entropy, reduction)
        return pg + vf_coef * v + ent_coef * e, (pg, v, e)

    def update(data: Dict[str, Any], perms: Sequence[torch.Tensor], coefs: Sequence[float]) -> torch.Tensor:
        clip_coef, ent_coef, vf_coef = (float(c) for c in coefs)
        rows, hrows = [], []
        for epoch in range(epochs):
            idxs = perms[epoch].to(first.device).reshape(num_minibatches, batch_size)
            for mb_idx in idxs:
                mb = {k: ({kk: vv[mb_idx] for kk, vv in v.items()} if isinstance(v, dict) else v[mb_idx])
                      for k, v in data.items()}
                if sentinel.skip_update:
                    with torch.no_grad():
                        torch._foreach_copy_(snapshot, guarded)
                total, aux = loss_fn(mb, clip_coef, ent_coef, vf_coef)
                grads = list(torch.autograd.grad(total, params))
                gnorm = global_norm(grads)
                clipped = clip_by_global_norm(grads, max_grad_norm) if max_grad_norm > 0 else grads
                for p, g in zip(params, clipped):
                    p.grad = g
                if health.enabled:
                    with torch.no_grad():
                        for n in names:
                            torch._foreach_copy_(before[n], groups[n])
                if schedule is not None:
                    set_lr()
                optimizer.step()
                optimizer.zero_grad(set_to_none=True)
                finite = finite_flag(gnorm, *aux)
                if health.enabled:
                    with torch.no_grad():
                        by_name = {n: [grads[index[id(p)]] for p in groups[n]] for n in names}
                        updates = {n: torch._foreach_sub(groups[n], before[n]) for n in names}
                        # the parameters before the update, as the JAX step's
                        stats = health_stats(by_name, updates, before, unit_dims=unit_dims,
                                             per_module=health.per_module, dead_eps=health.dead_eps)
                    hrows.append(torch.stack([stats[k] for k in health_out[:-1]]).float())
                if sentinel.skip_update:
                    select_finite(finite, guarded, snapshot)
                rows.append(torch.stack([*aux, gnorm, 1.0 - finite.float()]).float().detach())
        flat = torch.stack(rows)
        metrics = [flat[:, :4].mean(dim=0), flat[:, 4:].sum(dim=0)]
        if health.enabled:
            from sheeprl_tpu_torch.diagnostics.health import explained_variance

            metrics += [torch.stack(hrows).mean(dim=0), explained_variance(data["values"], data["returns"])[None]]
        return torch.cat(metrics)

    update.health_names = health_out
    return update


def rollout(agent: PPOAgent, envs, obs: Dict[str, np.ndarray], rb, stage, cfg, generator, aggregator, diag,
            spaces_of: Tuple[bool, bool]) -> Dict[str, np.ndarray]:
    """``algo.rollout_steps`` steps of every env into ``rb`` (the PPO and
    A2C loops' rollout): per step one policy forward on the staged
    observations, one fetch of its outputs, the envs stepping while the
    step is recorded, a truncated episode's reward bootstrapped from the
    value of its last observation, the episodes' statistics into
    ``aggregator``.  ``spaces_of`` is ``(is_continuous, is_multidiscrete)``.
    Returns the observations the rollout ends on."""
    from sheeprl_tpu_torch.data.slab import step_slab
    from sheeprl_tpu_torch.envs.player import fetch_values

    num_envs, gamma = int(cfg.env.num_envs), float(cfg.algo.gamma)
    obs_keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)
    for _ in range(int(cfg.algo.rollout_steps)):
        diag.note_env_steps(num_envs)
        actions, logprobs, _, values = agent(stage(obs, num_envs), generator=generator)
        diag.note_fetch()  # the step's one device-to-host copy
        actions_np, logprobs_np, values_np = fetch_values(actions, logprobs, values)
        # the envs step while this process records the step
        with diag.span("env_step_async"):
            envs.step_async(env_actions_of(actions_np, *spaces_of, num_envs))
        step_data = step_slab(num_envs, {**{k: obs[k] for k in obs_keys}, "actions": actions_np,
                                         "logprobs": logprobs_np, "values": values_np})
        with diag.span("env_wait"):
            next_obs, rewards, terminated, truncated, info = envs.step_wait()
        dones = np.logical_or(terminated, truncated).reshape(num_envs, 1).astype(np.float32)
        rewards = np.asarray(rewards, dtype=np.float32).reshape(num_envs, 1)
        if cfg.env.clip_rewards:
            rewards = np.tanh(rewards)
        # a truncated episode bootstraps from its last observation
        if "final_obs" in info and np.any(truncated):
            trunc_idx = np.nonzero(truncated)[0]
            stacked = {k: np.stack([np.asarray(info["final_obs"][i][k]) for i in trunc_idx]) for k in obs_keys}
            (vals,) = fetch_values(agent.get_values(stage(stacked, len(trunc_idx))))
            rewards[trunc_idx] += gamma * vals.reshape(-1, 1)
        step_data.update(step_slab(num_envs, {"rewards": rewards, "dones": dones}))
        rb.add(step_data, validate_args=cfg.buffer.validate_args)
        if "final_info" in info and "episode" in info["final_info"]:
            ep = info["final_info"]["episode"]
            mask = ep.get("_r", info["final_info"].get("_episode"))
            if mask is not None and np.any(mask):
                for r, length in zip(ep["r"][mask], ep["l"][mask]):
                    aggregator.update("Rewards/rew_avg", float(r))
                    aggregator.update("Game/ep_len_avg", float(length))
        obs = next_obs
    return obs


@torch.no_grad()
def rollout_data(agent: PPOAgent, rb, obs: Dict[str, np.ndarray], stage, cfg, device) -> Dict[str, Any]:
    """The rollout in ``rb`` as the update's ``[N, ...]`` rows on the
    device, with GAE's returns and advantages from the value of ``obs``,
    the observations the rollout ended on."""
    from sheeprl_tpu_torch.ops.numerics import gae

    rollout_steps, num_envs = int(cfg.algo.rollout_steps), int(cfg.env.num_envs)
    total = rollout_steps * num_envs
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    obs_keys = cnn_keys + list(cfg.algo.mlp_keys.encoder)
    local = {k: torch.from_numpy(np.ascontiguousarray(rb.buffer[k][:rollout_steps])).to(device) for k in rb.buffer}
    next_value = agent.get_values(stage(obs, num_envs))
    returns, advantages = gae(local["rewards"], local["values"], local["dones"], next_value,
                              float(cfg.algo.gamma), float(cfg.algo.gae_lambda))
    return {
        "obs": {k: local[k].reshape(total, -1, *local[k].shape[-2:]) if k in cnn_keys
                else local[k].reshape(total, -1).float() for k in obs_keys},
        "actions": local["actions"].reshape(total, -1),
        "logprobs": local["logprobs"].reshape(total, -1),
        "values": local["values"].reshape(total, -1),
        "returns": returns.reshape(total, -1),
        "advantages": advantages.reshape(total, -1),
    }


def _unported_options(cfg) -> List[str]:
    out = []
    if not cfg.model_manager.get("disabled", True):
        out.append("model_manager.disabled=False (model registry)")
    if cfg.metric.get("profiler", {}).get("enabled", False):
        out.append("metric.profiler.enabled=True")
    return out


def _minibatches(cfg) -> int:
    """The rollout's minibatches of ``algo.per_rank_batch_size`` rows."""
    batch_size = cfg.algo.per_rank_batch_size
    total_local = int(cfg.algo.rollout_steps) * int(cfg.env.num_envs)
    if batch_size is None or batch_size <= 0:
        raise ValueError(f"per_rank_batch_size must be a positive integer, got {batch_size}")
    if total_local % batch_size != 0:
        raise ValueError(f"The rollout ({total_local}) must be divisible by per_rank_batch_size ({batch_size})")
    return total_local // batch_size


def make_update(agent: PPOAgent, optimizer: torch.optim.Optimizer, cfg, total_iters: int):
    """PPO's update for :func:`_on_policy_main`: ``update(iter_num, data,
    generator) -> metrics``, the update phase (:func:`make_train_step`) on
    this iteration's annealed coefficients and permutations drawn from
    ``generator``, with ``algo.anneal_lr`` optax's linear schedule over
    every minibatch update of the run."""
    from sheeprl_tpu_torch.utils.utils import polynomial_decay

    batch_size, total_local = int(cfg.algo.per_rank_batch_size), int(cfg.algo.rollout_steps) * int(cfg.env.num_envs)
    num_minibatches, epochs = _minibatches(cfg), int(cfg.algo.update_epochs)
    schedule = None
    if cfg.algo.anneal_lr:
        schedule = linear_schedule(optimizer.param_groups[0]["lr"], 0.0, max(1, total_iters * epochs * num_minibatches))
    train_step = make_train_step(agent, optimizer, cfg, num_minibatches, batch_size, schedule)
    initial_ent, initial_clip = float(cfg.algo.ent_coef), float(cfg.algo.clip_coef)

    def update(iter_num: int, data: Dict[str, Any], generator: torch.Generator) -> torch.Tensor:
        clip_coef, ent_coef = initial_clip, initial_ent
        if cfg.algo.anneal_clip_coef:
            clip_coef = polynomial_decay(iter_num, initial=initial_clip, final=0.0, max_decay_steps=total_iters,
                                         power=1.0)
        if cfg.algo.anneal_ent_coef:
            ent_coef = polynomial_decay(iter_num, initial=initial_ent, final=0.0, max_decay_steps=total_iters,
                                        power=1.0)
        perms = [torch.randperm(total_local, generator=generator, device=data["returns"].device)
                 for _ in range(epochs)]
        return train_step(data, perms, (clip_coef, ent_coef, float(cfg.algo.vf_coef)))

    update.metric_order = METRIC_ORDER
    update.health_names = train_step.health_names
    update.updates_per_iteration = epochs * num_minibatches
    update.schedule = schedule is not None
    return update


class OnPolicyFamily:
    """The parts of :func:`_on_policy_main` that differ between the
    on-policy families: PPO's (and A2C's) here; recurrent PPO overrides them
    (``algos/ppo_recurrent/ppo_recurrent.py``)."""

    def unported(self, cfg) -> List[str]:
        return _unported_options(cfg)

    def buffer_size(self, cfg) -> int:
        return int(cfg.buffer.size)

    def checkpoint_batch_size(self, cfg) -> int:
        return cfg.algo.per_rank_batch_size

    def spec(self, agent) -> Dict[str, Any]:
        from sheeprl_tpu_torch.interop.flax_params import ppo_spec

        return ppo_spec(agent)

    def to_flax(self, agent) -> Dict[str, Any]:
        from sheeprl_tpu_torch.interop.flax_params import ppo_to_flax

        return ppo_to_flax(agent)

    def rollout(self, agent, envs, obs, rb, stage, cfg, generator, aggregator, diag, spaces_of):
        return rollout(agent, envs, obs, rb, stage, cfg, generator, aggregator, diag, spaces_of)

    def rollout_data(self, agent, rb, obs, stage, cfg, device) -> Dict[str, Any]:
        return rollout_data(agent, rb, obs, stage, cfg, device)

    def test(self, agent, env, cfg, device, stager) -> float:
        return test(agent, env, cfg, device, stager)


@register_algorithm()
def main(runtime, cfg) -> Dict[str, Any]:
    """The PPO loop (:func:`_on_policy_main` with PPO's agent and update)."""
    _minibatches(cfg)  # a rollout PPO cannot cut raises before the run starts
    return _on_policy_main(runtime, cfg, build_agent, make_update)


def _on_policy_main(runtime, cfg, build_agent_fn, make_update_fn,
                    family: Optional[OnPolicyFamily] = None) -> Dict[str, Any]:
    """The loop of the on-policy family (PPO, A2C): per iteration a rollout
    of ``algo.rollout_steps`` steps of every env (:func:`rollout`), GAE over
    it (:func:`rollout_data`), the update, logging and checkpoints; one
    greedy test episode at the end with ``algo.run_test``.
    ``build_agent_fn(actions_dim, is_continuous, cfg, obs_space,
    agent_state, device)`` builds the agent; ``make_update_fn(agent,
    optimizer, cfg, total_iters)`` the update ``update(iter_num, data,
    generator) -> metrics`` (the ``update.metric_order`` means, the
    non-finite update count, the ``update.health_names`` stats), whose
    ``updates_per_iteration`` counts ``Time/sps_train`` and ``schedule``
    says whether its optax state carries a schedule's count.  ``family``
    (PPO's by default) gives the options refused, the buffer's size, the
    agent's flax tree, the rollout, the update's data and the test episode.
    ``checkpoint.resume_from`` (a file, resolved by ``cli.run``) restores the
    agent, the optimizer's state (either package's) and the counters.
    Returns what the run did: its counters, the metric rows of every
    iteration, the logged metrics, the checkpoints and the log dir."""
    from sheeprl_tpu_torch.config import instantiate
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.env import make_env, make_env_fns, pipelined_vector_env
    from sheeprl_tpu_torch.envs.player import ObsStager, fetch_values, host_obs_slab
    from sheeprl_tpu_torch.interop.flax_params import optax_state, optimizer_state_dict
    from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
    from sheeprl_tpu_torch.utils.timer import timer
    from sheeprl_tpu_torch.utils.utils import get_diagnostics, save_configs

    family = family or OnPolicyFamily()
    unported = family.unported(cfg)
    if unported:
        raise NotImplementedError(f"not ported yet (see ROADMAP.md Queue 1): {'; '.join(unported)}")
    device = runtime.device
    num_envs = int(cfg.env.num_envs)
    total_local = int(cfg.algo.rollout_steps) * num_envs

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
    timer.reset()  # the registry is the class's: drop what an earlier run in this process left

    envs = pipelined_vector_env(cfg, make_env_fns(cfg, log_dir, "train"))
    observation_space, action_space = envs.single_observation_space, envs.single_action_space
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
    actions_dim, is_continuous, is_multidiscrete = actions_dim_of(action_space)

    resume_from = cfg.checkpoint.get("resume_from")
    state = runtime.load(resume_from) if resume_from else None
    agent = build_agent_fn(actions_dim, is_continuous, cfg, observation_space, state["agent"] if state else None,
                           device)
    # bf16-true: the weights themselves in bf16; *-mixed keeps fp32 masters
    agent.to(runtime.param_dtype)
    total_iters = int(cfg.algo.total_steps // total_local) if not cfg.dry_run else 1
    optimizer = instantiate(cfg.algo.optimizer)(agent.parameters())
    clip = bool(cfg.algo.max_grad_norm and cfg.algo.max_grad_norm > 0)
    spec = family.spec(agent)
    if state and "opt_state" in state:
        optimizer.load_state_dict(optimizer_state_dict(state["opt_state"], optimizer, spec))
    train_step = diag.instrument("train_step", make_update_fn(agent, optimizer, cfg, total_iters), kind="train")
    metric_order, health_out = train_step.metric_order, train_step.health_names
    n_losses = len(metric_order)
    diag.register_footprint("params", [agent])
    diag.register_footprint("opt_state", [optimizer])

    rb = ReplayBuffer(family.buffer_size(cfg), num_envs, memmap=cfg.buffer.memmap,
                      memmap_dir=os.path.join(log_dir, "memmap_buffer"))
    diag.track_buffer("replay", rb)

    start_iter = (state["iter_num"] if state else 0) + 1
    policy_step_count = state["policy_step"] if state else 0
    last_log = state["last_log"] if state else 0
    last_checkpoint = state["last_checkpoint"] if state else 0
    stager = ObsStager(device)

    def stage(host_obs: Dict[str, np.ndarray], n: int) -> Dict[str, torch.Tensor]:
        return stager(host_obs_slab(host_obs, cnn_keys, mlp_keys, n))

    obs = envs.reset(seed=cfg.seed)[0]
    metric_rows: List[np.ndarray] = []
    logged: List[Dict[str, float]] = []
    checkpoints: List[str] = []
    for iter_num in range(start_iter, total_iters + 1):
        agent.eval()
        with timer("Time/env_interaction_time"), diag.span("rollout"), torch.no_grad():
            obs = family.rollout(agent, envs, obs, rb, stage, cfg, generator, aggregator, diag,
                                 (is_continuous, is_multidiscrete))
        policy_step_count += total_local

        # ---- GAE over the rollout, on the device --------------------------
        with diag.span("buffer-sample"):
            data = diag.maybe_inject_nan(iter_num, family.rollout_data(agent, rb, obs, stage, cfg, device))

        # ---- the update: its device work ends inside the timer ------------
        # (between two CUDA events on the card, read at log time)
        agent.train()
        with timer("Time/train_time", device), diag.span("train"):
            metrics = train_step(iter_num, data, generator)
            (row,) = fetch_values(metrics)  # the iteration's one fetch of the update's results
        metric_rows.append(row)
        losses = dict(zip(metric_order, row[:n_losses].tolist()))
        if health_out:
            diag.on_health(policy_step_count, dict(zip(health_out, row[n_losses + 1:].tolist())))
        for name, value in losses.items():
            aggregator.update(name, value)
        diag.on_update(policy_step_count, losses, nonfinite=float(row[n_losses]))

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

        # a pending preemption (a signal, or the drill) forces the branch:
        # this save is the emergency snapshot
        preempt_now = diag.preempt_due(iter_num)
        if (
            (cfg.checkpoint.every > 0 and policy_step_count - last_checkpoint >= cfg.checkpoint.every)
            or cfg.dry_run
            or preempt_now
            or (iter_num == total_iters and cfg.checkpoint.save_last)
        ):
            last_checkpoint = policy_step_count
            ckpt_state = {
                "agent": family.to_flax(agent),
                # optax's layout, so that the JAX package resumes it too
                "opt_state": optax_state(optimizer, spec, clip=clip, schedule=train_step.schedule),
                "iter_num": iter_num,
                "policy_step": policy_step_count,
                "last_log": last_log,
                "last_checkpoint": last_checkpoint,
                "batch_size": family.checkpoint_batch_size(cfg),
            }
            ckpt_path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step_count}_0.ckpt")
            with diag.span("checkpoint"):
                runtime.call("on_checkpoint_coupled", ckpt_path=ckpt_path, state=ckpt_state, replay_buffer=None)
            diag.on_checkpoint(policy_step_count, ckpt_path)
            checkpoints.append(ckpt_path)
            if preempt_now:
                envs.close()
                diag.on_preempted(policy_step_count, iter_num, ckpt_path)

    envs.close()
    test_reward = None
    if cfg.algo.run_test:
        agent.eval()
        test_reward = family.test(agent, make_env(cfg, cfg.seed, 0, log_dir, "test")(), cfg, device, stager)
        logger.log_metrics({"Test/cumulative_reward": test_reward}, policy_step_count)
    logger.finalize()
    diag.close("completed")
    rows = np.asarray(metric_rows, np.float32).reshape(-1, n_losses + 1 + len(health_out))
    return {
        "start_iter": start_iter,
        "policy_steps": policy_step_count,
        "iterations": len(metric_rows),
        "updates_per_iteration": train_step.updates_per_iteration,
        "test_reward": test_reward,
        "metric_rows": rows[:, :n_losses],
        "nonfinite_updates": rows[:, n_losses],
        "health_rows": {name: rows[:, n_losses + 1 + i] for i, name in enumerate(health_out)},
        "logged": logged,
        "checkpoints": checkpoints,
        "log_dir": log_dir,
    }
