"""DreamerV2 training (counterpart of
``sheeprl_tpu/algos/dreamer_v2/dreamer_v2.py``): the gradient step, and
DreamerV3's loop (:func:`~sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3._dreamer_main`)
with the episode buffer, training in the JAX DreamerV2 loop's order.

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
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import (METRIC_ORDER, _dreamer_main, frozen, make_update, polyak,
                                                           step_of)
from sheeprl_tpu_torch.diagnostics.sentinel import sentinel_spec
from sheeprl_tpu_torch.ops.distributions import Bernoulli
from sheeprl_tpu_torch.parallel.dp import pmean_tree
from sheeprl_tpu_torch.parallel.precision import call_cast, compute_dtype_of
from sheeprl_tpu_torch.utils.registry import register_algorithm


def make_world_model_loss(world_model, cfg):
    """DreamerV2's world-model loss: ``loss(batch, generator, noise) ->
    (losses, posteriors, recurrents)``; ``losses`` are the six of
    ``reconstruction_loss`` (the total first), ``posteriors``/``recurrents``
    the dynamic scan's ``[T, B, ...]`` states.  The network inputs are cast
    to the compute dtype; the caller runs it under ``call_cast`` of the
    world model.  ``noise["dynamic"]`` is the scan's ``(prior, posterior)``
    Gumbel noise ``[T, B, stoch, discrete]``."""
    wm_cfg = cfg.algo.world_model
    stoch, discrete = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)
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

    return loss


class Imagination:
    """DreamerV2's behaviour learning in imagination, as its step and
    Plan2Explore-DV2's share it: the rollout, the continues, the
    bootstrapped lambda returns and the discounts, and the value loss."""

    def __init__(self, cfg):
        self.horizon, self.gamma, self.lmbda = int(cfg.algo.horizon), float(cfg.algo.gamma), float(cfg.algo.lmbda)
        self.use_continues = bool(cfg.algo.world_model.use_continues)

    def rollout(self, world_model, actor, posteriors, recurrents, generator, noise):
        """``(trajectories, actions)``, each ``[H+1, TB, ...]``: the start
        latents and ``H`` imagined steps, each action chosen from the latent
        before the step it leads to (on the latent detached), and a zero
        action to the first.  ``noise["imagination"]`` is the priors'
        Gumbel noise ``[H, TB, stoch, discrete]``, ``noise["actor"]`` the
        ``H`` per-head draws of the actions."""
        img_noise = noise.get("imagination")
        act_noise = noise.get("actor") or [None] * self.horizon
        latent0 = torch.cat([posteriors, recurrents], dim=-1)
        prior, recurrent, latent = posteriors, recurrents, latent0
        latents, actions = [latent0], []
        for h in range(self.horizon):
            action = actor.act(latent.detach(), generator, False, act_noise[h])
            prior, recurrent = world_model.imagination(prior, recurrent, action, generator,
                                                       None if img_noise is None else img_noise[h])
            latent = torch.cat([prior, recurrent], dim=-1)
            latents.append(latent)
            actions.append(action)
        return torch.stack(latents), torch.stack([torch.zeros_like(actions[0])] + actions)

    def returns(self, world_model, trajectories, rewards, target_values, true_continue):
        """``(lambda_values, discount)`` along the trajectories: the
        continue head's probabilities (the first step's the batch's own) or
        ``gamma`` without it, the returns bootstrapped on the last target
        value, and the discounts' cumulative product, which carries no
        gradient."""
        if self.use_continues:
            continues = torch.sigmoid(world_model.continue_logits(trajectories)).float()
            continues = torch.cat([true_continue[None], continues[1:]], dim=0)
        else:
            continues = torch.ones_like(rewards.detach()) * self.gamma
        lambda_values = compute_lambda_values(rewards[:-1], target_values[:-1], continues[:-1],
                                              bootstrap=target_values[-1:], horizon=self.horizon, lmbda=self.lmbda)
        discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-1]], dim=0), dim=0).detach()
        return lambda_values, discount

    @staticmethod
    def policy_loss(objective, entropies, discount, ent_coef: float) -> torch.Tensor:
        return -torch.mean(discount[:-2] * (objective + ent_coef * entropies))

    @staticmethod
    def value_loss(critic, trajectories, lambda_values, discount) -> torch.Tensor:
        """The ``Normal(., 1)`` loss of ``critic`` towards the lambda values
        under the discounts."""
        values = critic(trajectories[:-1])
        return -torch.mean(discount[:-1, ..., 0] * normal_log_prob(values, lambda_values, 1))


def make_train_step(agent, optimizers: Dict[str, torch.optim.Optimizer], cfg, is_continuous: bool):
    """Build one gradient step: ``train_step(moments_state, batch, tau,
    generator=None, noise=None) -> (moments_state, metrics)``, the Moments
    passed through (DreamerV2 keeps none); ``train_step.body`` is the step
    of one shard's block, its gradients and metrics averaged over the
    shards, as the JAX step ``pmean``s them.  ``batch`` leaves are ``[T, B,
    ...]`` float tensors on the device, pixels in [-0.5, 0.5].  ``noise``
    holds pre-drawn draws, each taken from ``generator`` when absent:
    ``"dynamic"`` the ``(prior, posterior)`` Gumbel noise ``[T, B, stoch,
    discrete]``; ``"imagination"`` the imagined priors' ``[H, T*B, stoch,
    discrete]``; ``"actor"`` the ``H`` per-head draws of the actions taken
    before each imagined step."""
    world_model, actor, critic, target_critic = agent.world_model, agent.actor, agent.critic, agent.target_critic
    wm_cfg = cfg.algo.world_model
    stoch, discrete = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)
    recurrent_size = int(wm_cfg.recurrent_model.recurrent_state_size)
    gamma = float(cfg.algo.gamma)
    objective_mix, ent_coef = float(cfg.algo.actor.objective_mix), float(cfg.algo.actor.ent_coef)
    cdt = compute_dtype_of(cfg)
    update = make_update(agent, optimizers, cfg)
    world_model_loss = make_world_model_loss(world_model, cfg)
    imagination = Imagination(cfg)

    def actor_loss(posteriors, recurrents, true_continue, generator, noise):
        trajectories, actions = imagination.rollout(world_model, actor, posteriors, recurrents, generator, noise)
        target_values = target_critic(trajectories).float()
        rewards = world_model.reward_logits(trajectories).float()
        lambda_values, discount = imagination.returns(world_model, trajectories, rewards, target_values, true_continue)
        log_probs, entropies = actor.log_prob_entropy(trajectories[:-2].detach(), actions[1:-1].detach())
        advantage = (lambda_values[1:] - target_values[:-2]).detach()
        objective = objective_mix * (log_probs * advantage) + (1 - objective_mix) * lambda_values[1:]
        policy_loss = imagination.policy_loss(objective, entropies, discount, ent_coef)
        return policy_loss, trajectories.detach(), lambda_values.detach(), discount

    def body(moments_state: Dict[str, Any], batch: Dict[str, torch.Tensor], tau: float,
             generator: Optional[torch.Generator] = None, noise: Optional[Dict[str, Any]] = None):
        noise = noise or {}
        T, B = batch["actions"].shape[:2]
        polyak(critic, target_critic, tau)

        losses, posteriors, recurrents = call_cast((world_model,), cdt,
                                                   lambda: world_model_loss(batch, generator, noise))
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = losses
        wm_norm = yield from update("world_model", rec_loss)

        posteriors = posteriors.detach().reshape(T * B, stoch * discrete)
        recurrents = recurrents.detach().reshape(T * B, recurrent_size)
        true_continue = (1 - batch["terminated"]).reshape(T * B, 1) * gamma
        with frozen(world_model, critic):
            policy_loss, trajectories, lambda_values, discount = call_cast(
                (world_model, actor, target_critic), cdt,
                lambda: actor_loss(posteriors, recurrents, true_continue, generator, noise))
            actor_norm = yield from update("actor", policy_loss)

        value_loss = call_cast((critic,), cdt,
                               lambda: imagination.value_loss(critic, trajectories, lambda_values, discount))
        critic_norm = yield from update("critic", value_loss)
        metrics = yield from pmean_tree(torch.stack([
            rec_loss, observation_loss, reward_loss, state_loss, continue_loss, kl, policy_loss, value_loss,
            wm_norm, actor_norm, critic_norm]).float().detach())
        return moments_state, metrics

    return step_of(body, METRIC_ORDER)


def unported_options(cfg, name: str) -> List[str]:
    """What the DreamerV1/V2 loops (and Plan2Explore's on them) refuse:
    ``skip_update``, which their JAX steps do not apply.  The JAX DreamerV1
    and V2 loops read ``model_manager`` and register nothing, and so do
    these (``_dreamer_main``'s ``register_models``)."""
    if sentinel_spec(cfg).skip_update:
        return [f"diagnostics.sentinel.policy=skip_update for {name} (its JAX step applies no selection)"]
    return []


def build_dreamer_v2_agent(actions_dim, is_continuous, cfg, obs_space, state, device):
    trees = None if state is None else {k: state[k] for k in ("world_model", "actor", "critic", "target_critic")}
    return build_agent(actions_dim, is_continuous, cfg, obs_space, trees, device)


@register_algorithm()
def main(runtime, cfg) -> Dict[str, Any]:
    """The DreamerV2 loop: DreamerV3's, with ``buffer.type`` (``sequential``
    or ``episode``), the gradient steps taken after the env step's rows
    reached the replay, as the JAX loop takes them.  The counter of the hard
    target update starts at 0 in every run, as the JAX loop's does, so a
    resumed run copies the target at its first gradient step; the
    ``gradient_steps`` an older port checkpoint holds is not read."""
    return _dreamer_main(runtime, cfg, build_dreamer_v2_agent, make_train_step,
                         unported_fn=lambda c: unported_options(c, "dreamer_v2"),
                         buffer_types=("sequential", "episode"), train_after_env_step=True, register_models=False,
                         dry_run_buffer_size=4)
