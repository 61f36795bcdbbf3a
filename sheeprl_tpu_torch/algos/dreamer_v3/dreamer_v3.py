"""DreamerV3 training (counterpart of
``sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py``): the gradient step and the
loop of env interaction, sequential replay and checkpoints.

A gradient step follows the JAX package's ``make_train_step`` in order: the
Polyak update of the target critic; the world-model loss over the dynamic
scan and its update; the actor loss over the imagination scan, against the
world model as just updated, with the Moments update; the critic loss and
update; the 11-entry metric vector.  A family that adds a term to the
world-model objective (DreamerV3-JEPA) reaches this step through its
``term`` seam (:class:`WorldModelTerm`), and the loop through
:func:`_dreamer_main`, as the JAX package runs its family through its
``_dreamer_main``.  JAX differentiates only the tree handed
to ``value_and_grad``; here each loss is differentiated with
``torch.autograd.grad`` over its own module's parameters, and the modules a
loss only reads have ``requires_grad`` off while it runs, so no gradient of
one loss reaches another optimizer.  The metric vector stays on the device;
the loop fetches the rows at log time.

Under ``diagnostics`` (the default) the step also computes the train-health
statistics (``diagnostics/health.py``) and stacks them onto the metric
vector, and with ``sentinel.policy=skip_update`` discards a non-finite step
on the device; the loop runs the facade's hooks (spans, telemetry, the
sentinel and health digests at the fetch, preemption, checkpoint events),
as the JAX package's loop does.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import TRAINED, Agent, PlayerDV3, build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v3.utils import (
    chunked_dynamic_scan,
    prepare_obs,
    real_actions_of,
    rssm_scan_spec,
    test,
    update_moments,
)
from sheeprl_tpu_torch.diagnostics.health import health_names, health_spec, health_stats
from sheeprl_tpu_torch.diagnostics.sentinel import select_finite, sentinel_spec, skip_update_guard
from sheeprl_tpu_torch.models.blocks import LayerNormGRUCell
from sheeprl_tpu_torch.ops.distributions import Bernoulli, MSEDistribution, SymlogDistribution, TwoHotEncodingDistribution
from sheeprl_tpu_torch.ops.numerics import compute_lambda_values
from sheeprl_tpu_torch.parallel.precision import call_cast, compute_dtype_of
from sheeprl_tpu_torch.utils.optim import clip_by_global_norm, global_norm
from sheeprl_tpu_torch.utils.registry import register_algorithm

METRIC_ORDER = [
    "Loss/world_model_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/kl",
    "Loss/policy_loss",
    "Loss/value_loss",
    "Grads/world_model",
    "Grads/actor",
    "Grads/critic",
]


@contextlib.contextmanager
def frozen(*modules: nn.Module) -> Iterator[None]:
    """``requires_grad`` off on the parameters of ``modules`` for the block:
    a loss that only reads a module builds no graph into it."""
    params = [p for m in modules for p in m.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def make_optimizers(cfg, agent: Agent) -> Dict[str, torch.optim.Optimizer]:
    """One optimizer per trained module, in the order and from the config
    sections ``agent.optimizer_configs`` names (each section's
    ``optimizer``), over what ``agent.parameters_of`` the module."""
    from sheeprl_tpu_torch.config import instantiate

    return {name: instantiate(section.optimizer)(agent.parameters_of(name))
            for name, section in agent.optimizer_configs(cfg).items()}


def optimizer_params(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for group in optimizer.param_groups for p in group["params"]]


def gradients(loss: torch.Tensor, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The gradient of ``loss`` over ``params``, zeros where it has none."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def apply_gradients(optimizer: torch.optim.Optimizer, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                    clip: float) -> None:
    """One optimizer step on ``grads`` clipped by their global norm (optax's
    ``chain(clip_by_global_norm(clip), ...)``)."""
    for p, g in zip(params, clip_by_global_norm(grads, clip)):
        p.grad = g
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def make_update(agent: Agent, optimizers: Dict[str, torch.optim.Optimizer], cfg) -> Callable:
    """``update(name, loss) -> norm``: the gradient of ``loss`` over the
    optimizer ``name``'s parameters, clipped by their global norm as its
    config section says, one step; the norm before clipping.  The plain
    update of the family's steps that keep no health stats (DreamerV1,
    DreamerV2)."""
    clip = {name: float(section.clip_gradients) for name, section in agent.optimizer_configs(cfg).items()}
    params = {name: optimizer_params(opt) for name, opt in optimizers.items()}

    def update(name: str, loss: torch.Tensor) -> torch.Tensor:
        grads = gradients(loss, params[name])
        norm = global_norm(grads)
        apply_gradients(optimizers[name], params[name], grads, clip[name])
        return norm

    return update


@torch.no_grad()
def polyak(module: nn.Module, target: nn.Module, tau: float) -> None:
    """``target <- tau * module + (1 - tau) * target``, tensor by tensor."""
    for c, t in zip(module.parameters(), target.parameters()):
        t.copy_(tau * c + (1 - tau) * t)


class WorldModelTerm(Protocol):
    """A term a family adds to the world-model objective, with what it needs
    around the world-model update (DreamerV3-JEPA's auxiliary loss).

    ``modules`` run in the loss's compute dtype beside the world model;
    ``loss(batch_obs, generator, noise)`` (called inside the world-model
    loss) returns the weighted term that loss adds and the entries
    appended to the metric vector, named ``metric_names``;
    ``health_groups`` names the parameters of the world-model optimizer
    that the health stats count as modules of their own, in the stats'
    module order after ``world_model``; ``after_update()`` runs right after
    the world-model update."""

    modules: Sequence[nn.Module]
    metric_names: Sequence[str]
    health_groups: Mapping[str, Sequence[torch.Tensor]]

    def loss(self, batch_obs: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
             noise: Dict[str, Any]) -> Tuple[torch.Tensor, List[torch.Tensor]]: ...

    def after_update(self) -> None: ...


def make_world_model_loss(world_model, cfg, term: Optional[WorldModelTerm] = None):
    """DreamerV3's world-model loss, as the family's steps share it:
    ``loss(batch, generator, noise) -> (losses, posteriors, recurrents,
    extra)``; ``losses`` are the six of ``reconstruction_loss`` (the total
    first), ``posteriors``/``recurrents`` the dynamic scan's ``[T, B, ...]``
    states and ``extra`` what ``term.loss`` returns (None without a term).
    The network inputs are cast to the compute dtype; the caller runs it
    under ``call_cast`` of the modules.  ``noise["dynamic"]`` and
    ``noise["burn_in"]`` are the scan's draws (see ``chunked_dynamic_scan``)."""
    wm_cfg = cfg.algo.world_model
    stoch, discrete = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)
    recurrent_size = int(wm_cfg.recurrent_model.recurrent_state_size)
    cdt = compute_dtype_of(cfg)
    chunks, burn_in = rssm_scan_spec(cfg)
    obs_keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)
    cnn_dec_keys = list(cfg.algo.cnn_keys.decoder)
    mlp_dec_keys = list(cfg.algo.mlp_keys.decoder)

    def loss(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator], noise: Dict[str, Any]):
        T, B = batch["actions"].shape[:2]
        target_obs = {k: batch[k] for k in set(cnn_dec_keys + mlp_dec_keys)}  # fp32 targets
        batch_obs = {k: batch[k].to(cdt) for k in obs_keys}  # the network's input
        # actions shift right by one: a_0 = 0
        batch_actions = torch.cat([torch.zeros_like(batch["actions"][:1]), batch["actions"][:-1]], dim=0).to(cdt)
        is_first = batch["is_first"].clone()
        is_first[0] = 1.0
        is_first = is_first.to(cdt)
        embedded = world_model.encode(batch_obs)
        recurrents, posteriors, post_logits, prior_logits = chunked_dynamic_scan(
            world_model, batch_actions, embedded, is_first, stoch_flat=stoch * discrete,
            recurrent_size=recurrent_size, chunks=chunks, burn_in=burn_in,
            stored_recurrent=batch.get("rssm_recurrent"), stored_posterior=batch.get("rssm_posterior"),
            stored_valid=batch.get("rssm_valid"), generator=generator, noise=noise.get("dynamic"),
            burn_in_noise=noise.get("burn_in"),
        )
        latents = torch.cat([posteriors, recurrents], dim=-1)
        recon = world_model.decode(latents)
        po = {k: MSEDistribution(recon[k], dims=recon[k].dim() - 2) for k in cnn_dec_keys}
        po.update({k: SymlogDistribution(recon[k], dims=recon[k].dim() - 2) for k in mlp_dec_keys})
        pr = TwoHotEncodingDistribution(world_model.reward_logits(latents), dims=1)
        pc = Bernoulli(world_model.continue_logits(latents), event_dims=1)
        losses = reconstruction_loss(
            po, target_obs, pr, batch["rewards"],
            prior_logits.reshape(T, B, stoch, discrete), post_logits.reshape(T, B, stoch, discrete),
            wm_cfg.kl_dynamic, wm_cfg.kl_representation, wm_cfg.kl_free_nats, wm_cfg.kl_regularizer,
            pc, 1 - batch["terminated"], wm_cfg.continue_scale_factor,
        )
        extra = term.loss(batch_obs, generator, noise) if term is not None else None
        return losses, posteriors, recurrents, extra

    return loss


class Behaviour:
    """Behaviour learning in imagination, as the family's steps share it:
    the rollout of an actor through the world model, the discounts, the
    policy objective, DreamerV3's actor loss against one critic and its
    Moments, and the two-hot critic loss against a target critic."""

    def __init__(self, cfg, is_continuous: bool):
        self.horizon = int(cfg.algo.horizon)
        self.gamma, self.lmbda = float(cfg.algo.gamma), float(cfg.algo.lmbda)
        self.moments_cfg = cfg.algo.actor.moments
        self.ent_coef = cfg.algo.actor.ent_coef
        self.is_continuous = is_continuous

    def rollout(self, world_model, actor, posteriors: torch.Tensor, recurrents: torch.Tensor,
                generator: Optional[torch.Generator], noise: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(trajectories, actions)``, each ``[H+1, TB, ...]``: the start
        latents and ``H`` imagined steps, the actor acting on each (on the
        latents detached).  ``noise["imagination"]`` is the prior Gumbel
        noise ``[H, TB, stoch, discrete]``, ``noise["actor"]`` the ``H + 1``
        per-head draws of the actor."""
        img_noise = noise.get("imagination")
        act_noise = noise.get("actor") or [None] * (self.horizon + 1)
        latent0 = torch.cat([posteriors, recurrents], dim=-1)
        actions = actor.act(latent0, generator, False, act_noise[0])
        prior, recurrent = posteriors, recurrents
        latents_h, actions_h = [latent0], [actions]
        for h in range(self.horizon):
            prior, recurrent = world_model.imagination(
                prior, recurrent, actions, generator, None if img_noise is None else img_noise[h]
            )
            latent = torch.cat([prior, recurrent], dim=-1)
            actions = actor.act(latent.detach(), generator, False, act_noise[h + 1])
            latents_h.append(latent)
            actions_h.append(actions)
        return torch.stack(latents_h), torch.stack(actions_h)

    def continues(self, world_model, trajectories: torch.Tensor,
                  true_continue: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The continue head's mode along the trajectories (the first step's
        the batch's own) and the discounts ``cumprod(continues * gamma) /
        gamma``, which carry no gradient."""
        continues = Bernoulli(world_model.continue_logits(trajectories), event_dims=1).mode
        continues = torch.cat([true_continue[None], continues[1:]], dim=0)
        return continues, (torch.cumprod(continues * self.gamma, dim=0) / self.gamma).detach()

    def lambda_values(self, rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor) -> torch.Tensor:
        return compute_lambda_values(rewards[1:], values[1:], continues[1:] * self.gamma, lmbda=self.lmbda)

    def advantage(self, moments_state: Dict[str, torch.Tensor], lambda_values: torch.Tensor,
                  baseline: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The advantage of ``lambda_values`` over ``baseline``, both scaled
        by the Moments as updated on ``lambda_values``; and those Moments."""
        m = self.moments_cfg
        offset, invscale, new_moments = update_moments(
            moments_state, lambda_values, m.decay, m.max, m.percentile.low, m.percentile.high
        )
        return (lambda_values - offset) / invscale - (baseline - offset) / invscale, new_moments

    def policy_loss(self, actor, trajectories: torch.Tensor, actions: torch.Tensor, advantage: torch.Tensor,
                    discount: torch.Tensor) -> torch.Tensor:
        """The objective is the advantage itself for continuous actions (its
        gradient reaches the actor through the imagined trajectories), the
        REINFORCE term otherwise; with the entropy bonus."""
        log_probs, entropies = actor.log_prob_entropy(trajectories.detach(), actions.detach())
        objective = advantage if self.is_continuous else log_probs[:-1] * advantage.detach()
        entropy = self.ent_coef * entropies
        return -torch.mean(discount[:-1] * (objective + entropy[:-1]))

    def actor_loss(self, world_model, actor, critic, posteriors: torch.Tensor, recurrents: torch.Tensor,
                   true_continue: torch.Tensor, moments_state: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator], noise: Dict[str, Any]):
        """DreamerV3's actor loss: ``(policy_loss, trajectories, lambda
        values, discount, moments)``, the trajectories and lambda values
        detached."""
        trajectories, actions = self.rollout(world_model, actor, posteriors, recurrents, generator, noise)
        predicted_values = TwoHotEncodingDistribution(critic(trajectories), dims=1).mean
        predicted_rewards = TwoHotEncodingDistribution(world_model.reward_logits(trajectories), dims=1).mean
        continues, discount = self.continues(world_model, trajectories, true_continue)
        lambda_values = self.lambda_values(predicted_rewards, predicted_values, continues)
        advantage, new_moments = self.advantage(moments_state, lambda_values, predicted_values[:-1])
        policy_loss = self.policy_loss(actor, trajectories, actions, advantage, discount)
        return policy_loss, trajectories.detach(), lambda_values.detach(), discount, new_moments

    @staticmethod
    def critic_loss(critic, target_critic, trajectories: torch.Tensor, lambda_values: torch.Tensor,
                    discount: torch.Tensor) -> torch.Tensor:
        """The two-hot value loss towards the lambda values and the target
        critic's values, weighted by the discounts."""
        qv = TwoHotEncodingDistribution(critic(trajectories[:-1]), dims=1)
        with torch.no_grad():
            target_values = TwoHotEncodingDistribution(target_critic(trajectories[:-1]), dims=1).mean
        value_loss = -qv.log_prob(lambda_values) - qv.log_prob(target_values)
        return torch.mean(value_loss * discount[:-1, ..., 0])


def make_train_step(agent: Agent, optimizers: Dict[str, torch.optim.Optimizer], cfg, is_continuous: bool,
                    term: Optional[WorldModelTerm] = None):
    """Build one gradient step:
    ``train_step(moments_state, batch, tau, generator=None, noise=None) ->
    (moments_state, metrics)``.  The modules and optimizers update in place.

    ``batch`` leaves are ``[T, B, ...]`` float tensors on the device, pixels
    already in [-0.5, 0.5]; with ``algo.rssm_chunks > 1`` it also holds the
    stored states (``RSSM_STATE_KEYS``).  Each loss runs its modules in the
    compute dtype of ``fabric.precision`` (``parallel/precision.py``): the
    parameters and network inputs are cast inside the loss, the targets and
    distributions stay fp32.  ``noise`` holds pre-drawn draws, each taken
    from ``generator`` when absent: ``"dynamic"`` the ``(prior, posterior)``
    Gumbel noise ``[T, B, stoch, discrete]`` of the dynamic scan and
    ``"burn_in"`` that of its burn-in steps (see ``chunked_dynamic_scan``);
    ``"imagination"`` the prior Gumbel noise ``[H, T*B, stoch, discrete]``;
    ``"actor"`` a list of ``H + 1`` per-head lists (Gumbel noise of each
    discrete head, or the draw of the continuous head) for the first action
    and each imagined step's; a ``term`` reads its own.

    ``term`` adds its loss to the world-model loss (the first metric is
    their sum, as in the JAX family's steps), its metric entries after the
    11 (``train_step.metric_order`` names them all), and its modules to what
    ``skip_update`` reverts when they are modules of ``agent``; the
    world-model gradient norm of the metrics stays the world model's own.
    With ``diagnostics.health`` on, ``metrics`` carries the health stats
    after the losses and norms, in the order of ``train_step.health_names``
    (the gradients before clipping, the update as the applied delta, the
    parameters after it).  With ``diagnostics.sentinel.policy=skip_update``
    a step whose losses or gradient norms are not all finite leaves every
    parameter (the target critic's too), Adam state and the Moments as they
    were, selected on the device (:func:`skip_update_guard`)."""
    world_model, actor, critic, target_critic = agent.world_model, agent.actor, agent.critic, agent.target_critic
    wm_cfg = cfg.algo.world_model
    stoch, discrete = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)
    recurrent_size = int(wm_cfg.recurrent_model.recurrent_state_size)
    cdt = compute_dtype_of(cfg)
    clip = {name: float(section.clip_gradients) for name, section in agent.optimizer_configs(cfg).items()}
    params = {name: optimizer_params(optimizers[name]) for name in TRAINED}
    world_model_loss = make_world_model_loss(world_model, cfg, term)
    behaviour = Behaviour(cfg, is_continuous)
    metric_order = METRIC_ORDER + list(term.metric_names if term is not None else ())
    term_modules = tuple(term.modules) if term is not None else ()
    term_params = {id(p) for group in (term.health_groups.values() if term is not None else ()) for p in group}
    sentinel, health = sentinel_spec(cfg), health_spec(cfg)
    if health.enabled:
        # the stats' modules: the optimizers', the world model's split by
        # the term's groups
        groups = {"world_model": [p for p in params["world_model"] if id(p) not in term_params],
                  **(dict(term.health_groups) if term is not None else {}),
                  "actor": params["actor"], "critic": params["critic"]}
        position = {id(p): (name, i) for name in TRAINED for i, p in enumerate(params[name])}
        where = {g: [position[id(p)] for p in ps] for g, ps in groups.items()}
        health_out = health_names(list(groups), health.per_module)
        # the parameters before each update, for the applied delta
        before = {name: [torch.empty_like(p) for p in params[name]] for name in TRAINED}
        unit_dims = health_unit_dims(agent, groups)
    else:
        health_out = []
    if sentinel.skip_update:
        guarded, snapshot = skip_update_guard(agent, optimizers.values())
    step_grads: Dict[str, List[torch.Tensor]] = {}

    def update(name: str, loss: torch.Tensor) -> torch.Tensor:
        """Gradient of ``loss`` over one optimizer's parameters, clipped by
        their global norm, one optimizer step; returns the norm before
        clipping (of the world model's own parameters for ``world_model``)."""
        grads = gradients(loss, params[name])
        norm = global_norm(grads)
        if term_params and name == "world_model":
            norm = global_norm([g for p, g in zip(params[name], grads) if id(p) not in term_params])
        if health.enabled:
            step_grads[name] = grads  # before clipping, as the JAX chain clips inside its update
            with torch.no_grad():
                torch._foreach_copy_(before[name], params[name])
        apply_gradients(optimizers[name], params[name], grads, clip[name])
        return norm

    def train_step(moments_state: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], tau: float,
                   generator: Optional[torch.Generator] = None, noise: Optional[Dict[str, Any]] = None):
        noise = noise or {}
        T, B = batch["actions"].shape[:2]
        if sentinel.skip_update:
            # before the Polyak update, as in JAX: a skipped step reverts the
            # target critic too
            with torch.no_grad():
                torch._foreach_copy_(snapshot, guarded)
            prev_moments = moments_state

        polyak(critic, target_critic, tau)

        # --- dynamic learning ----------------------------------------------
        losses, posteriors, recurrents, extra = call_cast(
            (world_model, *term_modules), cdt, lambda: world_model_loss(batch, generator, noise))
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = losses
        wm_loss = rec_loss if extra is None else rec_loss + extra[0]
        wm_norm = update("world_model", wm_loss)
        if term is not None:
            term.after_update()

        # --- behaviour learning, against the world model as just updated --
        posteriors = posteriors.detach().reshape(T * B, stoch * discrete)
        recurrents = recurrents.detach().reshape(T * B, recurrent_size)
        true_continue = (1 - batch["terminated"]).reshape(T * B, 1)
        with frozen(world_model, critic):
            policy_loss, trajectories, lambda_values, discount, moments_state = call_cast(
                (world_model, actor, critic), cdt, lambda: behaviour.actor_loss(
                    world_model, actor, critic, posteriors, recurrents, true_continue, moments_state, generator,
                    noise))
            actor_norm = update("actor", policy_loss)

        # --- critic learning -------------------------------------------------
        value_loss = call_cast((critic, target_critic), cdt, lambda: behaviour.critic_loss(
            critic, target_critic, trajectories, lambda_values, discount))
        critic_norm = update("critic", value_loss)

        metrics = torch.stack([
            wm_loss, observation_loss, reward_loss, state_loss, continue_loss, kl, policy_loss, value_loss,
            wm_norm, actor_norm, critic_norm, *(extra[1] if extra is not None else ()),
        ]).float().detach()
        if health.enabled:
            # the stats ride the metric vector, so the log interval's one
            # fetch carries them: no sync of their own
            with torch.no_grad():
                deltas = {name: torch._foreach_sub(params[name], before[name]) for name in TRAINED}

                def regroup(by_optimizer):
                    return {g: [by_optimizer[n][i] for n, i in at] for g, at in where.items()}

                stats = health_stats(regroup(step_grads), regroup(deltas), groups, unit_dims=unit_dims,
                                     per_module=health.per_module, dead_eps=health.dead_eps)
            metrics = torch.cat([metrics, torch.stack([stats[k] for k in health_out]).float()])
        step_grads.clear()
        if sentinel.skip_update:
            # the step's losses and gradient norms stand for every update:
            # a non-finite one discards them all, on the device
            finite = torch.isfinite(metrics[:len(metric_order)]).all()
            select_finite(finite, guarded, snapshot)
            moments_state = {k: torch.where(finite, v, prev_moments[k]) for k, v in moments_state.items()}
        return moments_state, metrics

    train_step.health_names = health_out
    train_step.metric_order = metric_order

    return train_step


def health_unit_dims(agent: Agent, params: Mapping[str, Sequence[torch.Tensor]]) -> Dict[str, List[int]]:
    """Each trained parameter's unit axis: the torch axis of its flax leaf's
    last axis, by the weight converter's layout kinds (``health.unit_dim``),
    so that ``dead_frac`` counts the units the JAX package counts."""
    from sheeprl_tpu_torch.diagnostics.health import unit_dim

    kinds: Dict[int, str] = {}

    def walk(spec: Any) -> None:
        for sub in (spec if isinstance(spec, list) else spec.values()):
            if isinstance(sub, (dict, list)):
                walk(sub)
            else:
                kinds[id(sub[0])] = sub[1]

    for name in TRAINED:
        walk(agent.optimizer_spec(name))
    return {name: [unit_dim(kinds.get(id(p), "same"), p.dim()) for p in ps] for name, ps in params.items()}


def stage_batch(sample: Dict[str, Any], cnn_keys: Sequence[str], device: torch.device) -> Dict[str, torch.Tensor]:
    """One gradient step's sample (host arrays, or the device ring's
    tensors) -> float32 device tensors, pixels (raw uint8) scaled to
    [-0.5, 0.5] on the device."""
    batch = {}
    for k, v in sample.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        t = t.to(device, non_blocking=True).float()
        batch[k] = t / 255.0 - 0.5 if k in cnn_keys else t
    return batch


def nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"a/b": x}`` -> ``{"a": {"b": x}}``: an optimizer named with a
    slash (one of a group, as P2E's per-critic ones) sits in the
    checkpoint's ``opt_states`` tree as the JAX package nests it."""
    out: Dict[str, Any] = {}
    for name, value in flat.items():
        *path, last = name.split("/")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[last] = value
    return out


def _at(tree: Mapping[str, Any], name: str) -> Any:
    for key in name.split("/"):
        tree = tree[key]
    return tree


def load_learner_state(state: Dict[str, Any], agent: Agent, optimizers: Dict[str, torch.optim.Optimizer],
                       device: torch.device | str) -> Dict[str, Any]:
    """A checkpoint's optimizer states (the port's or the JAX package's
    optax states) into ``optimizers``; returns its Moments, laid out as
    ``agent.initial_moments`` lays them out (DreamerV3's ``{low, high}``, or
    a family's tree of them), strictly."""
    from sheeprl_tpu_torch.interop.flax_params import optimizer_state_dict

    for name, opt in optimizers.items():
        opt.load_state_dict(optimizer_state_dict(_at(state["opt_states"], name), opt, agent.optimizer_spec(name)))
    if not agent.initial_moments(device):
        return {}  # a family that keeps no Moments (DreamerV1, DreamerV2)

    def restore(like: Any, saved: Any, path: str) -> Any:
        if not isinstance(like, Mapping):
            return torch.as_tensor(np.array(saved), dtype=torch.float32, device=device)
        if not isinstance(saved, Mapping) or set(saved) != set(like):
            raise KeyError(f"the checkpoint's moments{path} hold {sorted(saved) if isinstance(saved, Mapping) else saved}"
                           f", the agent's {sorted(like)}")
        return {k: restore(v, saved[k], f"{path}/{k}") for k, v in like.items()}

    return restore(agent.initial_moments(device), state["moments"], "")


def _unported_options(cfg) -> List[str]:
    """The options this loop reads and does not run (ROADMAP.md Queue 1);
    the runtime (devices) and the actor (its other distributions) refuse
    theirs where they are built, before the loop starts.  An offline run
    never reaches the loop: ``cli.run_algorithm`` routes it to
    ``offline/train.py``, and ``envs/env.py`` builds no env for it."""
    out = []
    if not cfg.model_manager.get("disabled", True):
        out.append("model_manager.disabled=False (model registry)")
    if cfg.metric.get("profiler", {}).get("enabled", False):
        out.append("metric.profiler.enabled=True")
    return out


def target_tau(cfg, gradient_steps: int) -> float:
    """The target critic's Polyak coefficient before gradient step
    ``gradient_steps`` (counted from 0 in every run): 1 at the first, the
    configured ``tau`` every ``per_rank_target_network_update_freq`` steps,
    else 0."""
    target_freq = cfg.algo.critic.get("per_rank_target_network_update_freq", 0)
    if target_freq and gradient_steps % target_freq == 0:
        return 1.0 if gradient_steps == 0 else float(cfg.algo.critic.get("tau", 1.0))
    return 0.0


def build_dreamer_agent(actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space,
                        state: Optional[Mapping[str, Any]], device: torch.device | str) -> Agent:
    """DreamerV3's agent for :func:`_dreamer_main`: from the four trees of a
    checkpoint ``state``, or from the seed when there is none."""
    trees = None if state is None else {k: state[k] for k in ("world_model", "actor", "critic", "target_critic")}
    return build_agent(actions_dim, is_continuous, cfg, obs_space, trees, device)


@register_algorithm()
def main(runtime, cfg) -> Dict[str, Any]:
    """The DreamerV3 loop (:func:`_dreamer_main` with DreamerV3's agent and
    step)."""
    return _dreamer_main(runtime, cfg, build_dreamer_agent, make_train_step)


def _dreamer_main(runtime, cfg, build_agent_fn: Callable[..., Agent], make_train_step_fn: Callable, *,
                  load_agent_state_fn: Optional[Callable[[Any, Any], Dict[str, Any]]] = None,
                  player_actor_fn: Optional[Callable[[bool], str]] = None,
                  final_test_fn: Optional[Callable[..., Tuple[float, int]]] = None,
                  unported_fn: Callable[[Any], List[str]] = None,
                  buffer_types: Sequence[str] = ("sequential",),
                  train_after_env_step: bool = False) -> Dict[str, Any]:
    """The DreamerV3 family's loop (the JAX package's ``_dreamer_main``):
    prefill with random actions, then per iteration a policy step of every
    env, a replay write, the gradient steps the replay ratio owes, logging
    and checkpoints; one test episode at the end when ``algo.run_test``.
    ``build_agent_fn(actions_dim, is_continuous, cfg, obs_space, state,
    device)`` builds the agent (from the checkpoint ``state`` when there is
    one), whose methods say which optimizers it has, what each trains and
    what a checkpoint holds (:class:`~sheeprl_tpu_torch.algos.dreamer_v3.agent.Agent`);
    ``make_train_step_fn(agent, optimizers, cfg, is_continuous)`` builds the
    gradient step.  With ``checkpoint.resume_from`` (a file, resolved by
    ``cli.run``) it restores the weights, optimizer states, Moments, replay
    ratio, counters and, with ``buffer.checkpoint``, the replay buffer, and
    waits ``algo.learning_starts`` more steps before training, as the JAX
    package does.

    The hooks a family sets (the JAX loop's): ``load_agent_state_fn(runtime,
    cfg)``, the state the agent, its optimizers and Moments start from when
    the run does not resume (with ``buffer.load_from_exploration`` its
    replay too); ``player_actor_fn(has_trained)``, the name of the agent's actor the
    player acts with, given whether a gradient step has run (``"actor"``);
    ``final_test_fn(player, agent, cfg, log_dir, generator)``, the test
    episode at the end (the player's actor once trained, sampled);
    ``unported_fn(cfg)``, the options the family refuses (DreamerV3's
    ``_unported_options``); ``buffer_types``, the ``buffer.type`` values the
    family reads (DreamerV3 samples sequentially and reads none; DreamerV2
    also has the ``episode`` buffer); ``train_after_env_step``, whether the
    iteration's gradient steps run after the env step's results, its reset
    rows and the player's re-initialisation (the JAX DreamerV1 and V2 loops'
    order) rather than while the envs step (DreamerV3's).  The counter that
    times the target critic's update starts at 0 in every run, resumed or
    not, as in every JAX loop of the family.

    Returns what the run did: its counters, the metric rows of every
    gradient step, the actor the player switched to at each iteration it
    changed, the checkpoints written and the log dir."""
    from sheeprl_tpu_torch.config import instantiate
    from sheeprl_tpu_torch.data.factory import make_dreamer_replay_buffer
    from sheeprl_tpu_torch.data.slab import rssm_state_slab, step_slab
    from sheeprl_tpu_torch.diagnostics.health import mean_stats
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.env import make_env_fns, pipelined_vector_env
    from sheeprl_tpu_torch.envs.player import ObsStager
    from sheeprl_tpu_torch.interop.flax_params import optax_state
    from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
    from sheeprl_tpu_torch.utils.timer import timer
    from sheeprl_tpu_torch.utils.utils import Ratio, get_diagnostics, save_configs

    unported = (unported_fn or _unported_options)(cfg)
    if unported:
        raise NotImplementedError(f"not ported yet (see ROADMAP.md Queue 1): {'; '.join(unported)}")
    buffer_type = str(cfg.buffer.get("type") or "sequential").lower() if len(buffer_types) > 1 else buffer_types[0]
    if buffer_type not in buffer_types:
        raise ValueError(f"Unrecognized buffer type: must be one of {list(buffer_types)}, got: {buffer_type}")
    device = runtime.device
    num_envs = int(cfg.env.num_envs)
    resume_from = cfg.checkpoint.get("resume_from")
    state = runtime.load(resume_from) if resume_from else None
    agent_state = state
    if agent_state is None and load_agent_state_fn is not None:
        agent_state = load_agent_state_fn(runtime, cfg)
    if player_actor_fn is None:
        player_actor_fn = lambda has_trained: "actor"  # noqa: E731
    cfg.env.frame_stack = -1
    if 2 ** int(np.log2(cfg.env.screen_size)) != cfg.env.screen_size:
        raise ValueError(f"The screen size must be a power of 2, got: {cfg.env.screen_size}")

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

    # reseeded from cfg.seed on resume too, as the JAX package does: a
    # resumed run's random stream is not the uninterrupted run's
    generator = runtime.seed_everything(cfg.seed)
    envs = pipelined_vector_env(cfg, make_env_fns(cfg, log_dir, "train"))
    action_space = envs.single_action_space
    observation_space = envs.single_observation_space
    is_continuous = isinstance(action_space, spaces.Box)
    is_multidiscrete = isinstance(action_space, spaces.MultiDiscrete)
    actions_dim = tuple(
        int(a) for a in (action_space.shape if is_continuous
                         else (action_space.nvec.tolist() if is_multidiscrete else [action_space.n]))
    )
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    has_decoders = len(cfg.algo.cnn_keys.decoder) + len(cfg.algo.mlp_keys.decoder) > 0
    if has_decoders and (
        not set(cfg.algo.cnn_keys.encoder) & set(cfg.algo.cnn_keys.decoder)
        and not set(cfg.algo.mlp_keys.encoder) & set(cfg.algo.mlp_keys.decoder)
    ):
        raise RuntimeError("The CNN keys or the MLP keys of the encoder and decoder must not be disjointed")
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    obs_keys = cnn_keys + mlp_keys

    agent = build_agent_fn(actions_dim, is_continuous, cfg, observation_space, agent_state, device)
    if device.type == "cuda" and any(isinstance(m, LayerNormGRUCell) and m.norm is not None
                                     for m in agent.world_model.modules()):
        # nvcc at first use, as the run state `compiling`
        diag.build_kernels(["ln_gru"])
    # bf16-true stores the weights themselves in bf16; *-mixed keeps fp32
    # masters and casts inside each loss
    for module in agent:
        module.to(runtime.param_dtype)
    has_trained = state is not None
    player = PlayerDV3(agent.world_model, getattr(agent, player_actor_fn(has_trained)), actions_dim, num_envs)
    optimizers = make_optimizers(cfg, agent)
    moments_state = agent.initial_moments(device) if agent_state is None else load_learner_state(
        agent_state, agent, optimizers, device)
    train_step = diag.instrument("train_step", make_train_step_fn(agent, optimizers, cfg, is_continuous),
                                 kind="train")
    metric_order, health_out = train_step.metric_order, train_step.health_names
    diag.register_footprint("params", list(agent))
    diag.register_footprint("opt_state", list(optimizers.values()))
    diag.register_footprint("moments", moments_state)

    buffer_size = cfg.buffer.size // num_envs if not cfg.dry_run else 2
    rb, use_device_buffer = make_dreamer_replay_buffer(
        cfg, num_envs, log_dir, buffer_size, device, buffer_type,
        minimum_episode_length=1 if cfg.dry_run else int(cfg.algo.per_rank_sequence_length), obs_keys=obs_keys)
    rb.seed(cfg.seed)
    diag.track_buffer("replay", rb)
    chunks = rssm_scan_spec(cfg)[0]
    # a finetuning run may go on from the exploration run's replay
    from_exploration = bool(cfg.buffer.get("load_from_exploration"))
    buffer_state = state if state is not None else (agent_state if from_exploration else None)
    if (buffer_state is not None and (cfg.buffer.checkpoint or from_exploration)
            and buffer_state.get("rb") is not None):
        rb.load_state_dict(buffer_state["rb"])
        loaded = rb.buffer[0].buffer if isinstance(rb.buffer, tuple) else rb.buffer
        if chunks > 1 and isinstance(loaded, dict) and loaded and "rssm_recurrent" not in loaded:
            raise ValueError(
                "algo.rssm_chunks > 1 needs replay rows carrying the player's RSSM state (rssm_recurrent/"
                "rssm_posterior/rssm_valid), but the restored buffer was collected without them: resume with "
                "rssm_chunks=1 or start a fresh buffer"
            )

    start_iter = (state["iter_num"] if state else 0) + 1
    policy_step_count = state["iter_num"] * num_envs if state else 0
    last_log = state["last_log"] if state else 0
    last_checkpoint = state["last_checkpoint"] if state else 0
    gradient_steps = player_steps = train_step_count = last_train = 0
    policy_steps_per_iter = num_envs
    total_iters = int(cfg.algo.total_steps // policy_steps_per_iter) if not cfg.dry_run else 1
    learning_starts = cfg.algo.learning_starts // policy_steps_per_iter if not cfg.dry_run else 0
    prefill_steps = learning_starts - int(learning_starts > 0)
    if state is not None:
        learning_starts += start_iter
        prefill_steps += start_iter
    ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)
    if state is not None and "ratio" in state:
        ratio.load_state_dict(state["ratio"])
    action_rng = np.random.default_rng(cfg.seed)

    obs = envs.reset(seed=cfg.seed)[0]
    step_data: Dict[str, Any] = step_slab(num_envs, {k: obs[k] for k in obs_keys})
    step_data["rewards"] = np.zeros((1, num_envs, 1), np.float32)
    step_data["truncated"] = np.zeros((1, num_envs, 1), np.float32)
    step_data["terminated"] = np.zeros((1, num_envs, 1), np.float32)
    step_data["is_first"] = np.ones_like(step_data["terminated"])
    player.init_states()
    # with the chunked scan every replay row also holds the player's
    # post-step state; rows without one (prefill, bookkeeping) hold zeros
    # and valid=0
    store_rssm_state = chunks > 1
    wm_cfg = cfg.algo.world_model
    zero_recurrent = np.zeros((num_envs, int(wm_cfg.recurrent_model.recurrent_state_size)), np.float32)
    zero_stochastic = np.zeros((num_envs, int(wm_cfg.stochastic_size) * int(wm_cfg.get("discrete_size") or 1)),
                               np.float32)
    stager = ObsStager(device)

    pending: List[torch.Tensor] = []
    metric_rows: List[np.ndarray] = []
    player_actors: List[Tuple[int, str]] = []
    first_train_iter = None
    logged: List[Dict[str, float]] = []
    checkpoints: List[str] = []

    def train_owed(iter_num: int) -> None:
        """The gradient steps the replay ratio owes at ``iter_num``."""
        nonlocal has_trained, first_train_iter, moments_state, gradient_steps, train_step_count
        if iter_num < learning_starts:
            return
        n = ratio(policy_step_count - prefill_steps * policy_steps_per_iter)
        if cfg.dry_run:
            n = 1
        if n <= 0:
            return
        has_trained = True
        if first_train_iter is None:
            first_train_iter = iter_num
        with diag.span("buffer-sample"):
            # the episode buffer's dry run samples single steps, as the JAX loop's
            seq_len = 1 if cfg.dry_run and buffer_type == "episode" else cfg.algo.per_rank_sequence_length
            local_data = rb.sample(cfg.algo.per_rank_batch_size, sequence_length=seq_len, n_samples=n)
            if not use_device_buffer:
                local_data = [{k: v[i] for k, v in local_data.items()} for i in range(n)]
        # on the card the timer records a CUDA event at each end of the
        # block, so the train time holds the device work of these steps
        # without waiting on it here (read at log time)
        with timer("Time/train_time", device), diag.span("train"):
            for sample in local_data:
                batch = diag.maybe_inject_nan(iter_num, stage_batch(sample, cnn_keys, device))
                moments_state, metrics = train_step(moments_state, batch, target_tau(cfg, gradient_steps), generator)
                pending.append(metrics)
                gradient_steps += 1
            train_step_count += 1

    for iter_num in range(start_iter, total_iters + 1):
        policy_step_count += policy_steps_per_iter
        diag.note_env_steps(num_envs)

        # ---- policy step, env step started, replay write ----------------
        # the envs step from here to step_wait, while this process writes the
        # replay row and (DreamerV3's order) runs the gradient steps owed
        with timer("Time/env_interaction_time"), diag.span("rollout"):
            if iter_num <= learning_starts and state is None:
                real_actions = envs.sample_actions(action_rng)
                if is_continuous:
                    actions = real_actions.astype(np.float32)
                else:
                    actions = np.concatenate(
                        [np.eye(d, dtype=np.float32)[real_actions.reshape(num_envs, -1)[:, i]]
                         for i, d in enumerate(actions_dim)],
                        axis=-1,
                    )
                step_data["actions"] = actions.reshape(1, num_envs, -1)
                if store_rssm_state:
                    step_data.update(rssm_state_slab(num_envs, zero_recurrent, zero_stochastic, valid=False))
            else:
                acting = player_actor_fn(has_trained)
                if not player_actors or player_actors[-1][1] != acting:
                    player.actor = getattr(agent, acting)
                    player_actors.append((iter_num, acting))
                torch_obs = prepare_obs(stager, obs, cnn_keys, mlp_keys, num_envs)
                actions_t = player.get_actions(torch_obs, generator)
                player_steps += 1
                diag.note_fetch()  # the iteration's one blocking copy below
                if use_device_buffer:
                    # the actions and the player's state go into the ring on
                    # the device; the action values cross once, for the envs
                    step_data["actions"] = actions_t.reshape(1, num_envs, -1)
                    if store_rssm_state:
                        step_data.update(rssm_state_slab(num_envs, player.state["recurrent"],
                                                         player.state["stochastic"], valid=True))
                    actions = actions_t.cpu().numpy()
                elif store_rssm_state:
                    # the stored state rides the same copy as the action values
                    fetched = torch.cat([actions_t, player.state["recurrent"], player.state["stochastic"]], -1)
                    actions, recurrent, stochastic = np.split(
                        fetched.cpu().numpy(), np.cumsum([actions_t.shape[-1], zero_recurrent.shape[-1]]),
                        axis=-1)
                    step_data.update(rssm_state_slab(num_envs, recurrent, stochastic, valid=True))
                    step_data["actions"] = actions.reshape(1, num_envs, -1)
                else:
                    actions = actions_t.cpu().numpy()  # the iteration's one fetch
                    step_data["actions"] = actions.reshape(1, num_envs, -1)
                real_actions = real_actions_of(actions, actions_dim, is_continuous)
            with diag.span("env_step_async"):
                envs.step_async(real_actions.reshape(envs.batched_action_shape))
            rb.add(step_data, validate_args=cfg.buffer.validate_args)

        # ---- the gradient steps the replay ratio owes, while the envs step
        if not train_after_env_step:
            train_owed(iter_num)

        # ---- the env step's results --------------------------------------
        with timer("Time/env_interaction_time"), diag.span("env_wait"):
            next_obs, rewards, terminated, truncated, infos = envs.step_wait()
        dones = np.logical_or(terminated, truncated).astype(np.uint8)
        step_data["is_first"] = np.zeros_like(step_data["terminated"])
        if "restart_on_exception" in infos:
            # a restarted env's last stored step becomes a truncation and its
            # next one a first step
            for i, restarted in enumerate(infos["restart_on_exception"]):
                if restarted and not dones[i]:
                    if use_device_buffer or buffer_type == "episode":
                        rb.mark_last_truncated(i)
                    else:
                        sub = rb.buffer[i]
                        last_idx = (sub._pos - 1) % sub.buffer_size
                        sub.buffer["terminated"][last_idx] = 0
                        sub.buffer["truncated"][last_idx] = 1
                        sub.buffer["is_first"][last_idx] = 0
                    step_data["is_first"][0, i] = 1
        if "final_info" in infos and "episode" in infos["final_info"]:
            ep = infos["final_info"]["episode"]
            mask = ep.get("_r", infos["final_info"].get("_episode"))
            if mask is not None and np.any(mask):
                for r, length in zip(ep["r"][mask], ep["l"][mask]):
                    aggregator.update("Rewards/rew_avg", float(r))
                    aggregator.update("Game/ep_len_avg", float(length))
        real_next_obs = {k: np.asarray(next_obs[k]).copy() for k in obs_keys}
        if "final_obs" in infos:
            for idx, final_obs in enumerate(infos["final_obs"]):
                if final_obs is not None:
                    for k in obs_keys:
                        real_next_obs[k][idx] = np.asarray(final_obs[k])
        step_data.update(
            step_slab(
                num_envs,
                {**{k: next_obs[k] for k in obs_keys}, "terminated": terminated, "truncated": truncated,
                 "rewards": rewards},
                dtypes={"terminated": np.float32, "truncated": np.float32, "rewards": np.float32},
            )
        )
        obs = next_obs
        if cfg.env.clip_rewards:
            step_data["rewards"] = np.tanh(step_data["rewards"])
        dones_idxes = dones.nonzero()[0].tolist()
        if dones_idxes:
            reset_data = {k: real_next_obs[k][dones_idxes][np.newaxis] for k in obs_keys}
            reset_data["terminated"] = step_data["terminated"][:, dones_idxes]
            reset_data["truncated"] = step_data["truncated"][:, dones_idxes]
            reset_data["actions"] = np.zeros((1, len(dones_idxes), int(sum(actions_dim))), np.float32)
            reset_data["rewards"] = step_data["rewards"][:, dones_idxes]
            reset_data["is_first"] = np.zeros_like(reset_data["terminated"])
            if store_rssm_state:
                # bookkeeping rows hold no player state (the env just reset)
                n_done = len(dones_idxes)
                reset_data.update(rssm_state_slab(n_done, zero_recurrent[:n_done], zero_stochastic[:n_done],
                                                  valid=False))
            rb.add(reset_data, dones_idxes, validate_args=cfg.buffer.validate_args)
            step_data["rewards"][:, dones_idxes] = 0
            step_data["terminated"][:, dones_idxes] = 0
            step_data["truncated"][:, dones_idxes] = 0
            step_data["is_first"][:, dones_idxes] = 1
            reset_mask = np.zeros((num_envs, 1), np.float32)
            reset_mask[dones_idxes] = 1.0
            player.init_states(torch.from_numpy(reset_mask).to(device))

        # ---- or after the env step's rows reached the replay -------------
        if train_after_env_step:
            train_owed(iter_num)

        # ---- log: the metric rows cross to the host here, in one copy ----
        if policy_step_count - last_log >= cfg.metric.log_every or iter_num == total_iters or cfg.dry_run:
            if pending:
                rows = torch.stack(pending).cpu().numpy()
                pending.clear()
                metric_rows.extend(rows)
                # the sentinel sees the raw rows before the aggregator drops
                # non-finite values (skip_update already acted on the device)
                diag.observe_rows(policy_step_count, metric_order, rows[:, :len(metric_order)])
                if health_out:
                    diag.on_health(policy_step_count, mean_stats(
                        [dict(zip(health_out, row[len(metric_order):])) for row in rows]))
                for row in rows:
                    for name, value in zip(metric_order, row):
                        aggregator.update(name, float(value))
            metrics_dict = aggregator.compute()
            timers = timer.compute()
            if timers.get("Time/train_time", 0) > 0:
                metrics_dict["Time/sps_train"] = (train_step_count - last_train) / timers["Time/train_time"]
            if timers.get("Time/env_interaction_time", 0) > 0:
                metrics_dict["Time/sps_env_interaction"] = (
                    (policy_step_count - last_log) * cfg.env.action_repeat) / timers["Time/env_interaction_time"]
            if policy_step_count > 0:
                metrics_dict["Params/replay_ratio"] = gradient_steps / policy_step_count
            logger.log_metrics(metrics_dict, policy_step_count)
            logged.append(dict(metrics_dict))
            aggregator.reset()
            timer.reset()
            last_log = policy_step_count
            last_train = train_step_count

        # ---- checkpoint --------------------------------------------------
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
                **agent.trees(),
                # optax's layout, so that the JAX package resumes it too
                "opt_states": nest({name: optax_state(opt, agent.optimizer_spec(name))
                                    for name, opt in optimizers.items()}),
                **({"moments": moments_state} if moments_state else {}),
                "ratio": ratio.state_dict(),
                "iter_num": iter_num,
                "batch_size": cfg.algo.per_rank_batch_size,
                "last_log": last_log,
                "last_checkpoint": last_checkpoint,
            }
            ckpt_path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step_count}_0.ckpt")
            with diag.span("checkpoint"):
                runtime.call("on_checkpoint_coupled", ckpt_path=ckpt_path, state=ckpt_state,
                             replay_buffer=rb if cfg.buffer.checkpoint else None)
            diag.on_checkpoint(policy_step_count, ckpt_path)
            checkpoints.append(ckpt_path)
            if preempt_now:
                envs.close()
                diag.on_preempted(policy_step_count, iter_num, ckpt_path)

    envs.close()
    test_reward, test_steps = None, 0
    if cfg.algo.run_test:
        if final_test_fn is None:
            player.actor = getattr(agent, player_actor_fn(True))
            test_reward, test_steps = test(player, cfg, log_dir, generator, greedy=False)
        else:
            test_reward, test_steps = final_test_fn(player, agent, cfg, log_dir, generator)
        logger.log_metrics({"Test/cumulative_reward": test_reward}, policy_step_count)
    logger.finalize()
    diag.close("completed")
    rows = np.asarray(metric_rows, np.float32).reshape(-1, len(metric_order) + len(health_out))
    return {
        "start_iter": start_iter,
        "policy_steps": policy_step_count,
        "player_steps": player_steps,
        "player_width": num_envs,
        "gradient_steps": gradient_steps,
        "test_steps": test_steps,
        "test_reward": test_reward,
        "player_actors": player_actors,
        "first_train_iter": first_train_iter,
        "metric_order": metric_order,
        "metric_rows": rows[:, :len(metric_order)],
        "health_rows": {name: rows[:, len(metric_order) + i] for i, name in enumerate(health_out)},
        "logged": logged,
        "checkpoints": checkpoints,
        "log_dir": log_dir,
    }
