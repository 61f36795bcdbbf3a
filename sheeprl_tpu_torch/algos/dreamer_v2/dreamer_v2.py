"""DreamerV2 training (counterpart of
``sheeprl_tpu/algos/dreamer_v2/dreamer_v2.py``): the gradient step, and
DreamerV3's loop (:func:`~sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3._dreamer_main`)
with the episode buffer and the gradient-step counter kept across a resume.

A gradient step follows the JAX package's ``make_train_step`` in order: the
target critic's hard update (``tau`` is 1 every
``critic.per_rank_target_network_update_freq`` gradient steps, 0
otherwise); the world-model loss over the dynamic scan (actions not shifted,
``is_first`` resets to the zero initial state) and its update; the actor
loss over ``horizon`` imagined steps against the world model as just
updated, mixing REINFORCE and the dynamics backpropagation by
``actor.objective_mix`` (below 1 the actor's gradient runs back through the
imagined GRU steps, on the card through the kernel's autograd ``Function``);
the critic's ``Normal(., 1)`` loss under the discount; the 11-entry metric
vector.  Each loss differentiates its own module's parameters; the modules
it only reads have ``requires_grad`` off.  The JAX step computes no health
stats and applies no ``skip_update`` selection, so neither does this one,
and ``run`` refuses ``diagnostics.sentinel.policy=skip_update``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v2.loss import normal_log_prob, reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v2.utils import compute_lambda_values
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import (
    METRIC_ORDER,
    _dreamer_main,
    frozen,
    make_update,
    polyak,
)
from sheeprl_tpu_torch.diagnostics.sentinel import sentinel_spec
from sheeprl_tpu_torch.ops.distributions import Bernoulli
from sheeprl_tpu_torch.parallel.precision import call_cast, compute_dtype_of
from sheeprl_tpu_torch.utils.registry import register_algorithm


def make_train_step(agent, optimizers: Dict[str, torch.optim.Optimizer], cfg, is_continuous: bool):
    """Build one gradient step: ``train_step(moments_state, batch, tau,
    generator=None, noise=None) -> (moments_state, metrics)``, the Moments
    passed through (DreamerV2 keeps none).  ``batch`` leaves are ``[T, B,
    ...]`` float tensors on the device, pixels in [-0.5, 0.5].  ``noise``
    holds pre-drawn draws, each taken from ``generator`` when absent:
    ``"dynamic"`` the ``(prior, posterior)`` Gumbel noise ``[T, B, stoch,
    discrete]``; ``"imagination"`` the imagined priors' ``[H, T*B, stoch,
    discrete]``; ``"actor"`` the ``H`` per-head draws of the actions taken
    before each imagined step."""
    world_model, actor, critic, target_critic = agent
    wm_cfg = cfg.algo.world_model
    stoch, discrete = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)
    recurrent_size = int(wm_cfg.recurrent_model.recurrent_state_size)
    horizon, gamma, lmbda = int(cfg.algo.horizon), float(cfg.algo.gamma), float(cfg.algo.lmbda)
    objective_mix, ent_coef = float(cfg.algo.actor.objective_mix), float(cfg.algo.actor.ent_coef)
    use_continues = bool(wm_cfg.use_continues)
    dec_keys = list(dict.fromkeys(list(cfg.algo.cnn_keys.decoder) + list(cfg.algo.mlp_keys.decoder)))
    cdt = compute_dtype_of(cfg)
    update = make_update(agent, optimizers, cfg)

    def world_model_loss(batch, generator, noise):
        T, B = batch["actions"].shape[:2]
        target_obs = {k: batch[k] for k in dec_keys}  # fp32 targets
        embedded = world_model.encode({k: v.to(cdt) for k, v in target_obs.items()})
        actions = batch["actions"].to(cdt)
        is_first = batch["is_first"].clone()
        is_first[0] = 1.0
        is_first = is_first.to(cdt)
        dyn_noise = noise.get("dynamic")
        posterior = torch.zeros((B, stoch * discrete), dtype=cdt, device=actions.device)
        recurrent = torch.zeros((B, recurrent_size), dtype=cdt, device=actions.device)
        recurrents, posteriors, post_logits, prior_logits = [], [], [], []
        for t in range(T):
            step_noise = None if dyn_noise is None else (dyn_noise[0][t], dyn_noise[1][t])
            recurrent, posterior, _, post_l, prior_l = world_model.dynamic(
                posterior, recurrent, actions[t], embedded[t], is_first[t], generator, step_noise)
            recurrents.append(recurrent)
            posteriors.append(posterior)
            post_logits.append(post_l)
            prior_logits.append(prior_l)
        recurrents, posteriors = torch.stack(recurrents), torch.stack(posteriors)
        latents = torch.cat([posteriors, recurrents], dim=-1)
        pc = continue_targets = None
        if use_continues:
            pc = Bernoulli(world_model.continue_logits(latents), event_dims=1)
            continue_targets = (1 - batch["terminated"]) * gamma
        losses = reconstruction_loss(
            world_model.decode(latents), target_obs, world_model.reward_logits(latents), batch["rewards"],
            torch.stack(prior_logits).reshape(T, B, stoch, discrete),
            torch.stack(post_logits).reshape(T, B, stoch, discrete),
            wm_cfg.kl_balancing_alpha, wm_cfg.kl_free_nats, wm_cfg.kl_free_avg, wm_cfg.kl_regularizer,
            pc, continue_targets, wm_cfg.discount_scale_factor,
        )
        return losses, posteriors, recurrents

    def actor_loss(posteriors, recurrents, true_continue, generator, noise):
        img_noise = noise.get("imagination")
        act_noise = noise.get("actor") or [None] * horizon
        latent0 = torch.cat([posteriors, recurrents], dim=-1)
        prior, recurrent, latent = posteriors, recurrents, latent0
        latents, actions = [latent0], []
        for h in range(horizon):
            action = actor.act(latent.detach(), generator, False, act_noise[h])
            prior, recurrent = world_model.imagination(prior, recurrent, action, generator,
                                                       None if img_noise is None else img_noise[h])
            latent = torch.cat([prior, recurrent], dim=-1)
            latents.append(latent)
            actions.append(action)
        trajectories = torch.stack(latents)  # [H+1, TB, L]
        # the action that led to each state; none to the first
        imagined_actions = torch.stack([torch.zeros_like(actions[0])] + actions)
        target_values = target_critic(trajectories).float()
        rewards = world_model.reward_logits(trajectories).float()
        if use_continues:
            continues = torch.sigmoid(world_model.continue_logits(trajectories)).float()
            continues = torch.cat([true_continue[None], continues[1:]], dim=0)
        else:
            continues = torch.ones_like(rewards.detach()) * gamma
        lambda_values = compute_lambda_values(rewards[:-1], target_values[:-1], continues[:-1],
                                              bootstrap=target_values[-1:], horizon=horizon, lmbda=lmbda)
        discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-1]], dim=0), dim=0).detach()
        log_probs, entropies = actor.log_prob_entropy(trajectories[:-2].detach(), imagined_actions[1:-1].detach())
        advantage = (lambda_values[1:] - target_values[:-2]).detach()
        objective = objective_mix * (log_probs * advantage) + (1 - objective_mix) * lambda_values[1:]
        policy_loss = -torch.mean(discount[:-2] * (objective + ent_coef * entropies))
        return policy_loss, trajectories.detach(), lambda_values.detach(), discount

    def train_step(moments_state: Dict[str, Any], batch: Dict[str, torch.Tensor], tau: float,
                   generator: Optional[torch.Generator] = None, noise: Optional[Dict[str, Any]] = None):
        noise = noise or {}
        T, B = batch["actions"].shape[:2]
        polyak(critic, target_critic, tau)

        losses, posteriors, recurrents = call_cast((world_model,), cdt,
                                                   lambda: world_model_loss(batch, generator, noise))
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = losses
        wm_norm = update("world_model", rec_loss)

        posteriors = posteriors.detach().reshape(T * B, stoch * discrete)
        recurrents = recurrents.detach().reshape(T * B, recurrent_size)
        true_continue = (1 - batch["terminated"]).reshape(T * B, 1) * gamma
        with frozen(world_model, critic):
            policy_loss, trajectories, lambda_values, discount = call_cast(
                (world_model, actor, target_critic), cdt,
                lambda: actor_loss(posteriors, recurrents, true_continue, generator, noise))
            actor_norm = update("actor", policy_loss)

        def critic_loss():
            values = critic(trajectories[:-1])
            return -torch.mean(discount[:-1, ..., 0] * normal_log_prob(values, lambda_values, 1))

        value_loss = call_cast((critic,), cdt, critic_loss)
        critic_norm = update("critic", value_loss)
        metrics = torch.stack([rec_loss, observation_loss, reward_loss, state_loss, continue_loss, kl, policy_loss,
                               value_loss, wm_norm, actor_norm, critic_norm]).float().detach()
        return moments_state, metrics

    train_step.metric_order = METRIC_ORDER
    train_step.health_names = []
    return train_step


def unported_options(cfg, name: str) -> List[str]:
    """What the DreamerV1/V2 loops refuse: ``skip_update``, which their JAX
    steps do not apply.  The JAX loops read no ``offline``,
    ``model_manager`` or ``profiler``, so neither do these."""
    if sentinel_spec(cfg).skip_update:
        return [f"diagnostics.sentinel.policy=skip_update for {name} (its JAX step applies no selection)"]
    return []


def build_dreamer_v2_agent(actions_dim, is_continuous, cfg, obs_space, state, device):
    trees = None if state is None else {k: state[k] for k in ("world_model", "actor", "critic", "target_critic")}
    return build_agent(actions_dim, is_continuous, cfg, obs_space, trees, device)


@register_algorithm()
def main(runtime, cfg) -> Dict[str, Any]:
    """The DreamerV2 loop: DreamerV3's, with ``buffer.type`` (``sequential``
    or ``episode``) and the gradient-step counter of the hard target update
    in the checkpoint."""
    return _dreamer_main(runtime, cfg, build_dreamer_v2_agent, make_train_step,
                         unported_fn=lambda c: unported_options(c, "dreamer_v2"), buffer_types=("sequential", "episode"),
                         keep_gradient_steps=True)
