"""DreamerV1 training (counterpart of
``sheeprl_tpu/algos/dreamer_v1/dreamer_v1.py``): the gradient step, and
DreamerV3's loop (:func:`~sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3._dreamer_main`).

A gradient step follows the JAX package's ``make_train_step``: the
world-model loss over the dynamic scan of the Gaussian RSSM (no
``is_first`` reset, actions not shifted) and its update; the actor loss,
``-mean(discount * lambda_values)`` over ``horizon`` imagined states
(pure dynamics backpropagation, through the world model as just updated);
the critic's ``Normal(., 1)`` loss on the ``horizon - 1`` lambda targets;
the 11-entry metric vector.  There is no target critic.  The recurrent
model is a plain GRU, so the step launches no kernel.  The JAX step computes
no health stats and applies no ``skip_update`` selection, so neither does
this one, and ``run`` refuses ``diagnostics.sentinel.policy=skip_update``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v1.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v1.utils import compute_lambda_values
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import unported_options
from sheeprl_tpu_torch.algos.dreamer_v2.loss import normal_log_prob
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_ORDER, _dreamer_main, frozen, make_update
from sheeprl_tpu_torch.ops.distributions import Bernoulli
from sheeprl_tpu_torch.parallel.precision import call_cast, compute_dtype_of
from sheeprl_tpu_torch.utils.registry import register_algorithm


def make_world_model_loss(world_model, cfg):
    """DreamerV1's world-model loss: ``loss(batch, generator, noise) ->
    (losses, posteriors, recurrents, embedded)``; ``losses`` are the six of
    ``reconstruction_loss`` (the total first), the rest the dynamic scan's
    ``[T, B, ...]`` states and the encoder's embedding (Plan2Explore-DV1's
    ensemble target).  The caller runs it under ``call_cast`` of the world
    model.  ``noise["dynamic"]`` is the scan's ``(prior, posterior)``
    standard-normal draws ``[T, B, stochastic]``."""
    wm_cfg = cfg.algo.world_model
    stoch = int(wm_cfg.stochastic_size)
    recurrent_size = int(wm_cfg.recurrent_model.recurrent_state_size)
    gamma = float(cfg.algo.gamma)
    use_continues = bool(wm_cfg.use_continues)
    dec_keys = list(dict.fromkeys(list(cfg.algo.cnn_keys.decoder) + list(cfg.algo.mlp_keys.decoder)))
    cdt = compute_dtype_of(cfg)

    def loss(batch, generator, noise):
        T, B = batch["actions"].shape[:2]
        target_obs = {k: batch[k] for k in dec_keys}  # fp32 targets
        embedded = world_model.encode({k: v.to(cdt) for k, v in target_obs.items()})
        actions = batch["actions"].to(cdt)
        dyn_noise = noise.get("dynamic")
        posterior = torch.zeros((B, stoch), dtype=cdt, device=actions.device)
        recurrent = torch.zeros((B, recurrent_size), dtype=cdt, device=actions.device)
        recurrents, posteriors, post_ms, prior_ms = [], [], [], []
        for t in range(T):
            step_noise = None if dyn_noise is None else (dyn_noise[0][t], dyn_noise[1][t])
            recurrent, posterior, _, post, prior = world_model.dynamic(posterior, recurrent, actions[t], embedded[t],
                                                                       generator, step_noise)
            recurrents.append(recurrent)
            posteriors.append(posterior)
            post_ms.append(post)
            prior_ms.append(prior)
        recurrents, posteriors = torch.stack(recurrents), torch.stack(posteriors)
        latents = torch.cat([posteriors, recurrents], dim=-1)
        qc = continue_targets = None
        if use_continues:
            qc = Bernoulli(world_model.continue_logits(latents), event_dims=1)
            continue_targets = (1 - batch["terminated"]) * gamma
        losses = reconstruction_loss(
            world_model.decode(latents), target_obs, world_model.reward_logits(latents), batch["rewards"],
            tuple(torch.stack([m[i] for m in post_ms]) for i in range(2)),
            tuple(torch.stack([m[i] for m in prior_ms]) for i in range(2)),
            wm_cfg.kl_free_nats, wm_cfg.kl_regularizer, qc, continue_targets, wm_cfg.continue_scale_factor,
        )
        return losses, posteriors, recurrents, embedded

    return loss


class Imagination:
    """DreamerV1's behaviour learning in imagination, as its step and
    Plan2Explore-DV1's share it: the rollout, the lambda targets and
    discounts, and the value loss."""

    def __init__(self, cfg):
        self.horizon, self.gamma, self.lmbda = int(cfg.algo.horizon), float(cfg.algo.gamma), float(cfg.algo.lmbda)
        self.use_continues = bool(cfg.algo.world_model.use_continues)

    def rollout(self, world_model, actor, posteriors, recurrents, generator, noise):
        """``(trajectories, actions)``, each ``[H, TB, ...]``: the imagined
        states only, and the action that led to each (chosen on the latent
        before it, detached).  ``noise["imagination"]`` is the priors'
        standard-normal draws ``[H, TB, stochastic]``, ``noise["actor"]``
        the ``H`` per-head draws of the actions."""
        img_noise = noise.get("imagination")
        act_noise = noise.get("actor") or [None] * self.horizon
        prior, recurrent = posteriors, recurrents
        latent = torch.cat([posteriors, recurrents], dim=-1)
        latents, actions = [], []
        for h in range(self.horizon):
            action = actor.act(latent.detach(), generator, False, act_noise[h])
            prior, recurrent = world_model.imagination(prior, recurrent, action, generator,
                                                       None if img_noise is None else img_noise[h])
            latent = torch.cat([prior, recurrent], dim=-1)
            latents.append(latent)
            actions.append(action)
        return torch.stack(latents), torch.stack(actions)

    def returns(self, world_model, trajectories, rewards, values):
        """``(lambda_values, discount)``: DreamerV1's ``H - 1`` lambda
        targets bootstrapped on the last value, under the continue head's
        probabilities (``gamma`` without it), and their discounts, which
        carry no gradient."""
        if self.use_continues:
            continues = torch.sigmoid(world_model.continue_logits(trajectories)).float()
        else:
            continues = torch.ones_like(rewards.detach()) * self.gamma
        lambda_values = compute_lambda_values(rewards, values, continues, values[-1], self.horizon, self.lmbda)
        discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-2]], dim=0), dim=0).detach()
        return lambda_values, discount

    @staticmethod
    def value_loss(critic, trajectories, lambda_values, discount) -> torch.Tensor:
        """The ``Normal(., 1)`` loss of ``critic`` on the first ``H - 1``
        states towards the lambda targets under the discounts."""
        values = critic(trajectories)[:-1]
        return -torch.mean(discount[..., 0] * normal_log_prob(values, lambda_values, 1))


def make_train_step(agent, optimizers: Dict[str, torch.optim.Optimizer], cfg, is_continuous: bool):
    """Build one gradient step: ``train_step(moments_state, batch, tau,
    generator=None, noise=None) -> (moments_state, metrics)``; ``tau`` and
    the Moments pass through (DreamerV1 has no target critic and keeps no
    Moments).  ``noise`` holds pre-drawn standard-normal draws, each taken
    from ``generator`` when absent: ``"dynamic"`` the ``(prior,
    posterior)`` draws ``[T, B, stochastic]``; ``"imagination"`` the
    imagined priors' ``[H, T*B, stochastic]``; ``"actor"`` the ``H``
    per-head draws of the actions taken before each imagined step."""
    world_model, actor, critic = agent.world_model, agent.actor, agent.critic
    wm_cfg = cfg.algo.world_model
    stoch = int(wm_cfg.stochastic_size)
    recurrent_size = int(wm_cfg.recurrent_model.recurrent_state_size)
    cdt = compute_dtype_of(cfg)
    update = make_update(agent, optimizers, cfg)
    world_model_loss = make_world_model_loss(world_model, cfg)
    imagination = Imagination(cfg)

    def actor_loss(posteriors, recurrents, generator, noise):
        trajectories, _ = imagination.rollout(world_model, actor, posteriors, recurrents, generator, noise)
        values = critic(trajectories).float()
        rewards = world_model.reward_logits(trajectories).float()
        lambda_values, discount = imagination.returns(world_model, trajectories, rewards, values)
        return -torch.mean(discount * lambda_values), trajectories.detach(), lambda_values.detach(), discount

    def train_step(moments_state: Dict[str, Any], batch: Dict[str, torch.Tensor], tau: float,
                   generator: Optional[torch.Generator] = None, noise: Optional[Dict[str, Any]] = None):
        noise = noise or {}
        T, B = batch["actions"].shape[:2]
        losses, posteriors, recurrents, _ = call_cast((world_model,), cdt,
                                                      lambda: world_model_loss(batch, generator, noise))
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = losses
        wm_norm = update("world_model", rec_loss)

        posteriors = posteriors.detach().reshape(T * B, stoch)
        recurrents = recurrents.detach().reshape(T * B, recurrent_size)
        with frozen(world_model, critic):
            policy_loss, trajectories, lambda_values, discount = call_cast(
                (world_model, actor, critic), cdt, lambda: actor_loss(posteriors, recurrents, generator, noise))
            actor_norm = update("actor", policy_loss)

        value_loss = call_cast((critic,), cdt,
                               lambda: imagination.value_loss(critic, trajectories, lambda_values, discount))
        critic_norm = update("critic", value_loss)
        metrics = torch.stack([rec_loss, observation_loss, reward_loss, state_loss, continue_loss, kl, policy_loss,
                               value_loss, wm_norm, actor_norm, critic_norm]).float().detach()
        return moments_state, metrics

    train_step.metric_order = METRIC_ORDER
    train_step.health_names = []
    return train_step


def build_dreamer_v1_agent(actions_dim, is_continuous, cfg, obs_space, state, device):
    trees = None if state is None else {k: state[k] for k in ("world_model", "actor", "critic")}
    return build_agent(actions_dim, is_continuous, cfg, obs_space, trees, device)


@register_algorithm()
def main(runtime, cfg) -> Dict[str, Any]:
    """The DreamerV1 loop: DreamerV3's, with DreamerV1's agent and step, the
    gradient steps taken after the env step's rows reached the replay, as
    the JAX loop takes them."""
    return _dreamer_main(runtime, cfg, build_dreamer_v1_agent, make_train_step,
                         unported_fn=lambda c: unported_options(c, "dreamer_v1"), train_after_env_step=True)
