"""Plan2Explore-DV1 exploration (counterpart of
``sheeprl_tpu/algos/p2e_dv1/p2e_dv1_exploration.py``): DreamerV3's loop
(``_dreamer_main``, its order, the sequential buffer), and a gradient step
of six updates in the JAX step's order.

1. World-model learning, DreamerV1's own (``make_world_model_loss``).
2. Ensemble learning: the N members predict the next observation's
   embedding (the encoder's, detached) from ``(posterior, recurrent,
   action)``, the ``Normal(., 1)`` log-prob summed over the members.
3. The exploration actor imagines against the world model and ensembles as
   just updated (DreamerV1's imagination) and learns by dynamics
   backpropagation of the lambda targets of the members' disagreement
   (their unbiased variance in fp32, averaged over the embedding, times
   ``intrinsic_reward_multiplier``, 10,000 in the preset) under its critic.
4. The exploration critic learns towards those targets.
5. The task actor imagines again (its own draws) and learns as DreamerV1's
   does, zero-shot; 6. the task critic learns.

DreamerV1's GRU has no LayerNorm: the step launches no kernel.  It carries
no health stats and applies no ``skip_update`` selection, as the JAX step
does not: ``run`` refuses ``diagnostics.sentinel.policy=skip_update``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import Imagination, make_world_model_loss
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import _dreamer_main, frozen, make_update
from sheeprl_tpu_torch.algos.p2e_dv1.agent import P2EDV1Agent, build_agent  # noqa: F401  (the family's builder)
from sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_exploration import (
    METRIC_ORDER,
    ensemble_loss,
    intrinsic_reward,
    p2e_unported_options,
)
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import _zero_shot_test
from sheeprl_tpu_torch.parallel.precision import call_cast, compute_dtype_of
from sheeprl_tpu_torch.utils.registry import register_algorithm


def make_train_step(agent: P2EDV1Agent, optimizers: Dict[str, torch.optim.Optimizer], cfg, is_continuous: bool):
    """Build one exploration gradient step: ``train_step(moments_state,
    batch, tau, generator=None, noise=None) -> (moments_state, metrics)``;
    ``tau`` and the Moments pass through (no target critics, no Moments).
    ``noise`` may hold the world model's ``"dynamic"`` draws and, under
    ``"exploration"`` and ``"task"``, each imagination's ``"imagination"``
    and ``"actor"`` draws (DreamerV1's layout); what is absent is drawn from
    ``generator``.  The metric vector is P2E-DV2's."""
    world_model, ensembles = agent.world_model, agent.ensembles
    actor_exploration, critic_exploration = agent.actor_exploration, agent.critic_exploration
    actor_task, critic_task = agent.actor_task, agent.critic_task
    wm_cfg = cfg.algo.world_model
    stoch = int(wm_cfg.stochastic_size)
    recurrent_size = int(wm_cfg.recurrent_model.recurrent_state_size)
    multiplier = float(cfg.algo.intrinsic_reward_multiplier)
    cdt = compute_dtype_of(cfg)
    update = make_update(agent, optimizers, cfg)
    world_model_loss = make_world_model_loss(world_model, cfg)
    imagination = Imagination(cfg)

    def exploration_loss(posteriors, recurrents, generator, noise):
        trajectories, actions = imagination.rollout(world_model, actor_exploration, posteriors, recurrents,
                                                    generator, noise)
        values = critic_exploration(trajectories).float()
        reward = intrinsic_reward(ensembles, trajectories.detach(), actions.detach(), multiplier)
        lambda_values, discount = imagination.returns(world_model, trajectories, reward, values)
        return (-torch.mean(discount * lambda_values), trajectories.detach(), lambda_values.detach(), discount,
                reward.mean(), values.detach().mean())

    def task_loss(posteriors, recurrents, generator, noise):
        trajectories, _ = imagination.rollout(world_model, actor_task, posteriors, recurrents, generator, noise)
        values = critic_task(trajectories).float()
        rewards = world_model.reward_logits(trajectories).float()
        lambda_values, discount = imagination.returns(world_model, trajectories, rewards, values)
        return -torch.mean(discount * lambda_values), trajectories.detach(), lambda_values.detach(), discount

    def train_step(moments_state: Dict[str, Any], batch: Dict[str, torch.Tensor], tau: float,
                   generator: Optional[torch.Generator] = None, noise: Optional[Dict[str, Any]] = None):
        noise = noise or {}
        T, B = batch["actions"].shape[:2]

        # --- 1) dynamic learning, DreamerV1's ------------------------------
        losses, posteriors, recurrents, embedded = call_cast((world_model,), cdt,
                                                             lambda: world_model_loss(batch, generator, noise))
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = losses
        wm_norm = update("world_model", rec_loss)
        posteriors, recurrents, embedded = posteriors.detach(), recurrents.detach(), embedded.detach()

        # --- 2) ensemble learning: the next embedding -------------------------
        ens_loss = call_cast((ensembles,), cdt, lambda: ensemble_loss(
            ensembles, torch.cat([posteriors, recurrents, batch["actions"].to(cdt)], dim=-1), embedded))
        ens_norm = update("ensembles", ens_loss)

        flat_post = posteriors.reshape(T * B, stoch)
        flat_rec = recurrents.reshape(T * B, recurrent_size)

        # --- 3, 4) exploration behaviour and its critic ------------------------
        with frozen(world_model, critic_exploration, ensembles):
            policy_loss_expl, trajectories, lambda_values, discount, reward, predicted = call_cast(
                (world_model, actor_exploration, critic_exploration, ensembles), cdt,
                lambda: exploration_loss(flat_post, flat_rec, generator, noise.get("exploration", {})))
            actor_expl_norm = update("actor_exploration", policy_loss_expl)
        value_loss_expl = call_cast((critic_exploration,), cdt, lambda: imagination.value_loss(
            critic_exploration, trajectories, lambda_values, discount))
        critic_expl_norm = update("critic_exploration", value_loss_expl)
        lambda_mean = lambda_values.mean()

        # --- 5, 6) task behaviour, zero-shot ------------------------------------
        with frozen(world_model, critic_task):
            policy_loss_task, trajectories, lambda_values, discount = call_cast(
                (world_model, actor_task, critic_task), cdt,
                lambda: task_loss(flat_post, flat_rec, generator, noise.get("task", {})))
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


@register_algorithm()
def main(runtime, cfg) -> Dict[str, Any]:
    """The exploration loop: DreamerV3's (``_dreamer_main``) with the
    P2E-DV1 agent and step; the player acts with the exploration actor
    throughout (``algo.player.actor_type`` is forced to ``exploration``) and
    the final test runs the task actor zero-shot."""
    cfg.algo.player.actor_type = "exploration"
    return _dreamer_main(runtime, cfg, build_agent, make_train_step,
                         player_actor_fn=lambda has_trained: "actor_exploration", final_test_fn=_zero_shot_test,
                         unported_fn=lambda c: p2e_unported_options(c, "p2e_dv1_exploration"))
