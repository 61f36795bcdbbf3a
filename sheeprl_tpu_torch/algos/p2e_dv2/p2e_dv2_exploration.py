"""Plan2Explore-DV2 exploration (counterpart of
``sheeprl_tpu/algos/p2e_dv2/p2e_dv2_exploration.py``): DreamerV3's loop
(``_dreamer_main``, its order and tau rule, the sequential buffer), and a
gradient step of six updates in the JAX step's order, after the hard copy
of both critics into their targets (``tau``).

1. World-model learning, DreamerV2's own (``make_world_model_loss``).
2. Ensemble learning: the N members predict the next posterior from
   ``(posterior, recurrent, action)``, the ``Normal(., 1)`` log-prob summed
   over the members.
3. The exploration actor imagines against the world model and ensembles as
   just updated (DreamerV2's imagination: the action from the latent before
   each step, a zero action to the first); its reward is the members'
   disagreement (their unbiased variance, in fp32, averaged over the state,
   times ``intrinsic_reward_multiplier``), its returns bootstrapped on the
   exploration target critic; the pure objective: dynamics backpropagation
   for continuous actions, REINFORCE against the target critic's baseline
   otherwise.
4. The exploration critic learns towards those returns.
5. The task actor imagines again (its own draws) and learns as DreamerV2's
   does, mixing the two by ``actor.objective_mix``, zero-shot on the
   exploration data; 6. the task critic learns.

Both imaginations run the LayerNorm-GRU kernel ``H`` times at ``T * B``
rows, the dynamic scan ``T`` times at ``B``.  The step carries no health
stats and applies no ``skip_update`` selection, as the JAX step does not:
``run`` refuses ``diagnostics.sentinel.policy=skip_update``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import Imagination, make_world_model_loss, unported_options
from sheeprl_tpu_torch.algos.dreamer_v2.loss import normal_log_prob
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import (
    _dreamer_main,
    _unported_options,
    frozen,
    make_update,
    polyak,
)
from sheeprl_tpu_torch.algos.p2e_dv2.agent import P2EDV2Agent, build_agent  # noqa: F401  (the family's builder)
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import _zero_shot_test
from sheeprl_tpu_torch.parallel.precision import call_cast, compute_dtype_of
from sheeprl_tpu_torch.utils.registry import register_algorithm

METRIC_ORDER = [
    "Loss/world_model_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/kl",
    "Loss/ensemble_loss",
    "Loss/policy_loss_exploration",
    "Loss/value_loss_exploration",
    "Loss/policy_loss_task",
    "Loss/value_loss_task",
    "Rewards/intrinsic",
    "Values_exploration/predicted_values",
    "Values_exploration/lambda_values",
    "Grads/world_model",
    "Grads/ensemble",
    "Grads/actor_exploration",
    "Grads/critic_exploration",
    "Grads/actor_task",
    "Grads/critic_task",
]


def intrinsic_reward(ensembles, trajectories: torch.Tensor, actions: torch.Tensor, multiplier: float) -> torch.Tensor:
    """The members' disagreement on ``(trajectories, actions)``: their
    unbiased variance in fp32, averaged over the last axis, times
    ``multiplier``; no gradient."""
    with torch.no_grad():
        preds = ensembles(torch.cat([trajectories, actions], dim=-1)).float()
        return preds.var(dim=0, unbiased=True).mean(-1, keepdim=True) * multiplier


def ensemble_loss(ensembles, inputs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Each member's ``Normal(., 1)`` log-prob of ``target[1:]`` from
    ``inputs[:-1]``, averaged over time and batch, summed over the
    members."""
    outs = ensembles(inputs)[:, :-1]  # [N, T-1, B, out]
    return -normal_log_prob(outs, target[1:].expand_as(outs), 1).mean(dim=(1, 2)).sum()


def make_train_step(agent: P2EDV2Agent, optimizers: Dict[str, torch.optim.Optimizer], cfg, is_continuous: bool):
    """Build one exploration gradient step: ``train_step(moments_state,
    batch, tau, generator=None, noise=None) -> (moments_state, metrics)``,
    the Moments passed through (none are kept).  ``batch`` and the precision
    policy are DreamerV2's; ``noise`` may hold the world model's
    ``"dynamic"`` draws and, under ``"exploration"`` and ``"task"``, each
    imagination's ``"imagination"`` and ``"actor"`` draws (DreamerV2's
    layout); what is absent is drawn from ``generator``."""
    world_model, ensembles = agent.world_model, agent.ensembles
    actor_exploration, critic_exploration = agent.actor_exploration, agent.critic_exploration
    target_critic_exploration = agent.target_critic_exploration
    actor_task, critic_task, target_critic_task = agent.actor_task, agent.critic_task, agent.target_critic_task
    wm_cfg = cfg.algo.world_model
    stoch_flat = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size)
    recurrent_size = int(wm_cfg.recurrent_model.recurrent_state_size)
    gamma = float(cfg.algo.gamma)
    objective_mix, ent_coef = float(cfg.algo.actor.objective_mix), float(cfg.algo.actor.ent_coef)
    multiplier = float(cfg.algo.intrinsic_reward_multiplier)
    cdt = compute_dtype_of(cfg)
    update = make_update(agent, optimizers, cfg)
    world_model_loss = make_world_model_loss(world_model, cfg)
    imagination = Imagination(cfg)

    def exploration_loss(posteriors, recurrents, true_continue, generator, noise):
        trajectories, actions = imagination.rollout(world_model, actor_exploration, posteriors, recurrents,
                                                    generator, noise)
        target_values = target_critic_exploration(trajectories).float()
        reward = intrinsic_reward(ensembles, trajectories.detach(), actions.detach(), multiplier)
        lambda_values, discount = imagination.returns(world_model, trajectories, reward, target_values, true_continue)
        log_probs, entropies = actor_exploration.log_prob_entropy(trajectories[:-2].detach(),
                                                                  actions[1:-1].detach())
        # the pure objectives: dynamics backpropagation, or REINFORCE
        # against the exploration target critic's baseline
        objective = lambda_values[1:] if is_continuous else \
            log_probs * (lambda_values[1:] - target_values[:-2]).detach()
        policy_loss = imagination.policy_loss(objective, entropies, discount, ent_coef)
        return (policy_loss, trajectories.detach(), lambda_values.detach(), discount, reward.mean(),
                target_values.detach().mean())

    def task_loss(posteriors, recurrents, true_continue, generator, noise):
        trajectories, actions = imagination.rollout(world_model, actor_task, posteriors, recurrents, generator, noise)
        target_values = target_critic_task(trajectories).float()
        rewards = world_model.reward_logits(trajectories).float()
        lambda_values, discount = imagination.returns(world_model, trajectories, rewards, target_values, true_continue)
        log_probs, entropies = actor_task.log_prob_entropy(trajectories[:-2].detach(), actions[1:-1].detach())
        advantage = (lambda_values[1:] - target_values[:-2]).detach()
        objective = objective_mix * (log_probs * advantage) + (1 - objective_mix) * lambda_values[1:]
        policy_loss = imagination.policy_loss(objective, entropies, discount, ent_coef)
        return policy_loss, trajectories.detach(), lambda_values.detach(), discount

    def train_step(moments_state: Dict[str, Any], batch: Dict[str, torch.Tensor], tau: float,
                   generator: Optional[torch.Generator] = None, noise: Optional[Dict[str, Any]] = None):
        noise = noise or {}
        T, B = batch["actions"].shape[:2]
        polyak(critic_task, target_critic_task, tau)
        polyak(critic_exploration, target_critic_exploration, tau)

        # --- 1) dynamic learning, DreamerV2's ------------------------------
        losses, posteriors, recurrents = call_cast((world_model,), cdt,
                                                   lambda: world_model_loss(batch, generator, noise))
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = losses
        wm_norm = update("world_model", rec_loss)
        posteriors, recurrents = posteriors.detach(), recurrents.detach()

        # --- 2) ensemble learning --------------------------------------------
        ens_loss = call_cast((ensembles,), cdt, lambda: ensemble_loss(
            ensembles, torch.cat([posteriors, recurrents, batch["actions"].to(cdt)], dim=-1), posteriors))
        ens_norm = update("ensembles", ens_loss)

        flat_post = posteriors.reshape(T * B, stoch_flat)
        flat_rec = recurrents.reshape(T * B, recurrent_size)
        true_continue = (1 - batch["terminated"]).reshape(T * B, 1) * gamma

        # --- 3) exploration behaviour, against the updated models ----------
        with frozen(world_model, critic_exploration, ensembles):
            policy_loss_expl, trajectories, lambda_values, discount, reward, predicted = call_cast(
                (world_model, actor_exploration, target_critic_exploration, ensembles), cdt,
                lambda: exploration_loss(flat_post, flat_rec, true_continue, generator, noise.get("exploration", {})))
            actor_expl_norm = update("actor_exploration", policy_loss_expl)

        # --- 4) the exploration critic ----------------------------------------
        value_loss_expl = call_cast((critic_exploration,), cdt, lambda: imagination.value_loss(
            critic_exploration, trajectories, lambda_values, discount))
        critic_expl_norm = update("critic_exploration", value_loss_expl)
        lambda_mean = lambda_values.mean()

        # --- 5, 6) task behaviour, zero-shot ------------------------------------
        with frozen(world_model, critic_task):
            policy_loss_task, trajectories, lambda_values, discount = call_cast(
                (world_model, actor_task, target_critic_task), cdt,
                lambda: task_loss(flat_post, flat_rec, true_continue, generator, noise.get("task", {})))
            actor_task_norm = update("actor_task", policy_loss_task)
        value_loss_task = call_cast((critic_task,), cdt, lambda: imagination.value_loss(
            critic_task, trajectories, lambda_values, discount))
        critic_task_norm = update("critic_task", value_loss_task)

        metrics = torch.stack([
            rec_loss, observation_loss, reward_loss, state_loss, continue_loss, kl, ens_loss, policy_loss_expl,
            value_loss_expl, policy_loss_task, value_loss_task, reward, predicted, lambda_mean, wm_norm, ens_norm,
            actor_expl_norm, critic_expl_norm, actor_task_norm, critic_task_norm,
        ]).float().detach()
        return moments_state, metrics

    train_step.metric_order = METRIC_ORDER
    train_step.health_names = []
    return train_step


def p2e_unported_options(cfg, name: str) -> List[str]:
    """What the Plan2Explore-DV1/V2 loops refuse: DreamerV3's loop's
    options (offline, the model registry, the profiler) and
    ``skip_update``, which their JAX steps do not apply."""
    return _unported_options(cfg) + unported_options(cfg, name)


@register_algorithm()
def main(runtime, cfg) -> Dict[str, Any]:
    """The exploration loop: DreamerV3's (``_dreamer_main``) with the
    P2E-DV2 agent and step; the player acts with the exploration actor
    throughout (``algo.player.actor_type`` is forced to ``exploration``) and
    the final test runs the task actor zero-shot."""
    cfg.algo.player.actor_type = "exploration"
    return _dreamer_main(runtime, cfg, build_agent, make_train_step,
                         player_actor_fn=lambda has_trained: "actor_exploration", final_test_fn=_zero_shot_test,
                         unported_fn=lambda c: p2e_unported_options(c, "p2e_dv2_exploration"))
