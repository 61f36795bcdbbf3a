"""Plan2Explore-DV3 exploration (counterpart of
``sheeprl_tpu/algos/p2e_dv3/p2e_dv3_exploration.py``): DreamerV3's loop,
and a gradient step of five phases in the JAX step's order, after the
Polyak update of the task critic's target and of every exploration critic's.

1. World-model learning, DreamerV3's own (``make_world_model_loss``).
2. Ensemble learning: the N members predict the next posterior from
   ``(posterior, recurrent, action)``, the MSE log-prob summed over them.
3. The exploration actor imagines against the world model and ensembles
   as just updated; each exploration critic adds its advantage, weighted by
   ``weight / sum(weights)`` and scaled by its own Moments, its reward the
   ensembles' disagreement (the members' unbiased variance, in fp32, times
   ``intrinsic_reward_multiplier``) or the world model's reward head.
4. Each exploration critic learns with its own optimizer.
5. The task actor and critic learn as DreamerV3's do, zero-shot on the
   exploration data (``Behaviour``).

Both imaginations run DreamerV3's rollout, so each runs the LayerNorm-GRU
kernel ``H`` times at ``T * B`` rows.  The step carries no health stats and
applies no ``skip_update`` selection, as the JAX P2E step does not: ``run``
refuses ``diagnostics.sentinel.policy=skip_update`` here rather than run
it unapplied.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import (
    Behaviour,
    _dreamer_main,
    apply_gradients,
    frozen,
    gradients,
    make_world_model_loss,
    optimizer_params,
    polyak,
)
from sheeprl_tpu_torch.algos.dreamer_v3.utils import test
from sheeprl_tpu_torch.algos.p2e_dv3.agent import P2EAgent, build_agent, exploration_critics_spec
from sheeprl_tpu_torch.algos.p2e_dv3.utils import expand_exploration_metric_keys
from sheeprl_tpu_torch.diagnostics.sentinel import sentinel_spec
from sheeprl_tpu_torch.ops.distributions import MSEDistribution, TwoHotEncodingDistribution
from sheeprl_tpu_torch.parallel.precision import call_cast, compute_dtype_of
from sheeprl_tpu_torch.utils.optim import global_norm
from sheeprl_tpu_torch.utils.registry import register_algorithm


def metric_order(critics_spec: Sequence[Tuple[str, float, str]]) -> List[str]:
    """The metric vector: 15 fixed entries, then each exploration critic's
    value loss, mean predicted value and mean lambda value, and an intrinsic
    critic's mean reward.  ``Grads/critic_exploration_<name>`` is among the
    aggregator's keys but, as in the JAX step, never logged."""
    order = [
        "Loss/world_model_loss",
        "Loss/observation_loss",
        "Loss/reward_loss",
        "Loss/state_loss",
        "Loss/continue_loss",
        "State/kl",
        "Loss/ensemble_loss",
        "Loss/policy_loss_exploration",
        "Loss/policy_loss_task",
        "Loss/value_loss_task",
        "Grads/world_model",
        "Grads/ensemble",
        "Grads/actor_exploration",
        "Grads/actor_task",
        "Grads/critic_task",
    ]
    for name, _, reward_type in critics_spec:
        order += [f"Loss/value_loss_exploration_{name}", f"Values_exploration/predicted_values_{name}",
                  f"Values_exploration/lambda_values_{name}"]
        if reward_type == "intrinsic":
            order.append(f"Rewards/intrinsic_{name}")
    return order


def make_train_step(agent: P2EAgent, optimizers: Dict[str, torch.optim.Optimizer], cfg, is_continuous: bool):
    """Build one exploration gradient step:
    ``train_step(moments_state, batch, tau, generator=None, noise=None) ->
    (moments_state, metrics)``, ``moments_state`` ``{"task": ...,
    "exploration": {name: ...}}``.  ``batch`` and the precision policy are
    DreamerV3's (:func:`~sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3.make_train_step`).
    ``noise`` may hold the world model's ``"dynamic"`` / ``"burn_in"``
    draws and, under ``"exploration"`` and ``"task"``, each imagination's
    ``"imagination"`` and ``"actor"`` draws (DreamerV3's layout); what is
    absent is drawn from ``generator``."""
    critics_spec = exploration_critics_spec(cfg)
    world_model, ensembles = agent.world_model, agent.ensembles
    actor_exploration, critics = agent.actor_exploration, agent.critics_exploration
    actor_task, critic_task, target_critic_task = agent.actor_task, agent.critic_task, agent.target_critic_task
    wm_cfg = cfg.algo.world_model
    stoch_flat = int(wm_cfg.stochastic_size * wm_cfg.discrete_size)
    recurrent_size = int(wm_cfg.recurrent_model.recurrent_state_size)
    cdt = compute_dtype_of(cfg)
    clip = {name: float(section.clip_gradients) for name, section in agent.optimizer_configs(cfg).items()}
    params = {name: optimizer_params(opt) for name, opt in optimizers.items()}
    weights_sum = sum(weight for _, weight, _ in critics_spec)
    intrinsic_multiplier = float(cfg.algo.intrinsic_reward_multiplier)
    world_model_loss = make_world_model_loss(world_model, cfg)
    behaviour = Behaviour(cfg, is_continuous)

    def update(name: str, loss: torch.Tensor) -> torch.Tensor:
        """One optimizer's step on the gradient of ``loss``; returns the
        gradient's norm before clipping."""
        grads = gradients(loss, params[name])
        norm = global_norm(grads)
        apply_gradients(optimizers[name], params[name], grads, clip[name])
        return norm

    def train_step(moments_state: Dict[str, Any], batch: Dict[str, torch.Tensor], tau: float,
                   generator: Optional[torch.Generator] = None, noise: Optional[Dict[str, Any]] = None):
        noise = noise or {}
        T, B = batch["actions"].shape[:2]
        polyak(critic_task, target_critic_task, tau)
        for name, _, _ in critics_spec:
            polyak(critics[name].module, critics[name].target_module, tau)

        # --- 1) dynamic learning, DreamerV3's --------------------------------
        losses, posteriors, recurrents, _ = call_cast(
            (world_model,), cdt, lambda: world_model_loss(batch, generator, noise))
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = losses
        wm_norm = update("world_model", rec_loss)
        posteriors, recurrents = posteriors.detach(), recurrents.detach()

        # --- 2) ensemble learning ---------------------------------------------
        def ensemble_loss() -> torch.Tensor:
            inputs = torch.cat([posteriors, recurrents, batch["actions"].to(cdt)], dim=-1)
            outs = ensembles(inputs)[:, :-1]  # [N, T-1, B, stoch]
            log_prob = MSEDistribution(outs, dims=1).log_prob(posteriors[1:].expand_as(outs))
            return -log_prob.mean(dim=(1, 2)).sum()

        ens_loss = call_cast((ensembles,), cdt, ensemble_loss)
        ens_norm = update("ensembles", ens_loss)

        # --- 3) exploration behaviour, against the updated models ----------
        flat_post = posteriors.reshape(T * B, stoch_flat)
        flat_rec = recurrents.reshape(T * B, recurrent_size)
        true_continue = (1 - batch["terminated"]).reshape(T * B, 1)

        def exploration_loss():
            trajectories, actions = behaviour.rollout(world_model, actor_exploration, flat_post, flat_rec, generator,
                                                      noise.get("exploration", {}))
            continues, discount = behaviour.continues(world_model, trajectories, true_continue)
            with torch.no_grad():
                # the members' disagreement: their unbiased variance, in fp32
                preds = ensembles(torch.cat([trajectories, actions], dim=-1)).float()
                intrinsic_reward = preds.var(dim=0, unbiased=True).mean(-1, keepdim=True) * intrinsic_multiplier
            task_reward = TwoHotEncodingDistribution(world_model.reward_logits(trajectories), dims=1).mean
            advantage, moments, per_critic = 0.0, {}, {}
            for name, weight, reward_type in critics_spec:
                values = TwoHotEncodingDistribution(critics[name].module(trajectories), dims=1).mean
                reward = intrinsic_reward if reward_type == "intrinsic" else task_reward
                lambda_values = behaviour.lambda_values(reward, values, continues)
                critic_advantage, moments[name] = behaviour.advantage(
                    moments_state["exploration"][name], lambda_values, values[:-1])
                advantage = advantage + critic_advantage * (weight / weights_sum)
                per_critic[name] = (lambda_values.detach(), values.detach().mean(), reward.detach().mean())
            policy_loss = behaviour.policy_loss(actor_exploration, trajectories, actions, advantage, discount)
            return policy_loss, trajectories.detach(), discount, moments, per_critic

        with frozen(world_model, critics, ensembles):
            policy_loss_exploration, trajectories, discount, moments_exploration, per_critic = call_cast(
                (world_model, actor_exploration, critics, ensembles), cdt, exploration_loss)
            actor_exploration_norm = update("actor_exploration", policy_loss_exploration)

        # --- 4) each exploration critic, with its own optimizer ----------------
        critic_metrics = []
        for name, _, reward_type in critics_spec:
            lambda_values, predicted, reward = per_critic[name]
            critic = critics[name]
            value_loss = call_cast((critic,), cdt, lambda: behaviour.critic_loss(
                critic.module, critic.target_module, trajectories, lambda_values, discount))
            update(f"critics_exploration/{name}", value_loss)
            critic_metrics += [value_loss, predicted, lambda_values.mean()]
            if reward_type == "intrinsic":
                critic_metrics.append(reward)

        # --- 5) task behaviour, zero-shot ----------------------------------------
        with frozen(world_model, critic_task):
            policy_loss_task, trajectories, lambda_values, discount, moments_task = call_cast(
                (world_model, actor_task, critic_task), cdt, lambda: behaviour.actor_loss(
                    world_model, actor_task, critic_task, flat_post, flat_rec, true_continue, moments_state["task"],
                    generator, noise.get("task", {})))
            actor_task_norm = update("actor_task", policy_loss_task)
        value_loss_task = call_cast((critic_task, target_critic_task), cdt, lambda: behaviour.critic_loss(
            critic_task, target_critic_task, trajectories, lambda_values, discount))
        critic_task_norm = update("critic_task", value_loss_task)

        metrics = torch.stack([
            rec_loss, observation_loss, reward_loss, state_loss, continue_loss, kl, ens_loss,
            policy_loss_exploration, policy_loss_task, value_loss_task, wm_norm, ens_norm, actor_exploration_norm,
            actor_task_norm, critic_task_norm, *critic_metrics,
        ]).float().detach()
        return {"task": moments_task, "exploration": moments_exploration}, metrics

    train_step.health_names = []
    train_step.metric_order = metric_order(critics_spec)
    return train_step


def refuse_skip_update(cfg) -> None:
    """The JAX P2E step applies no ``skip_update`` selection, so neither
    does this one; a run that asks for it is refused, not run unapplied."""
    if sentinel_spec(cfg).skip_update:
        raise NotImplementedError(
            "diagnostics.sentinel.policy=skip_update: the JAX package's P2E exploration step applies no skip_update "
            "selection (and returns no health stats), so the port's does not either; use policy=warn or halt")


def _zero_shot_test(player, agent: P2EAgent, cfg, log_dir, generator) -> Tuple[float, int]:
    """The final test, zero-shot with the task actor."""
    player.actor = agent.actor_task
    return test(player, cfg, log_dir, generator, greedy=False, test_name="zero-shot")


@register_algorithm()
def main(runtime, cfg) -> Dict[str, Any]:
    """The exploration loop: DreamerV3's (``_dreamer_main``) with the P2E
    agent and step; the player acts with the exploration actor throughout
    (``algo.player.actor_type`` is forced to ``exploration``), the metric
    keys of the exploration critics are expanded per critic, and the final
    test runs the task actor zero-shot."""
    refuse_skip_update(cfg)
    cfg.algo.player.actor_type = "exploration"
    expand_exploration_metric_keys(cfg, [name for name, _, _ in exploration_critics_spec(cfg)])
    return _dreamer_main(runtime, cfg, build_agent, make_train_step,
                         player_actor_fn=lambda has_trained: "actor_exploration", final_test_fn=_zero_shot_test)
