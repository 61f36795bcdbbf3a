"""A2C training (counterpart of ``sheeprl_tpu/algos/a2c/a2c.py``): one
gradient step over the whole rollout per iteration.

The loss runs on the agent's parameters and the observations cast to the
compute dtype of ``fabric.precision``, as the JAX loss casts them.  The
reference accumulates the minibatches' gradients into one optimizer step; with ``sum``/``mean`` reductions that is the whole batch's gradient,
so the JAX package, and the port, take it in one step.  The loss is
``policy_loss + vf_coef * value_loss`` with ``algo.loss_reduction``; the
gradient is clipped by its global norm when ``algo.max_grad_norm > 0`` and
the optimizer is ``algo.optimizer`` (optax's ``rmsprop`` by default:
``sheeprl_tpu_torch/utils/optim.py::RMSprop``).  The rollout, GAE, the
truncation bootstrap, the test episode and the loop are PPO's
(``algos/ppo/ppo.py``).  Under ``diagnostics`` (the default) the step also
computes the train-health stats and the value function's explained
variance, and with ``sentinel.policy=skip_update`` discards a non-finite
step on the device.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from sheeprl_tpu_torch.algos.a2c.agent import A2CAgent, build_agent
from sheeprl_tpu_torch.algos.a2c.loss import policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.ppo import _module_groups, _on_policy_main
from sheeprl_tpu_torch.diagnostics.health import explained_variance, health_names, health_spec, health_stats
from sheeprl_tpu_torch.diagnostics.sentinel import finite_flag, select_finite, sentinel_spec, skip_update_guard
from sheeprl_tpu_torch.parallel.precision import call_cast, cast_floating, compute_dtype_of
from sheeprl_tpu_torch.utils.optim import clip_by_global_norm, global_norm
from sheeprl_tpu_torch.utils.registry import register_algorithm

METRIC_ORDER = ["Loss/policy_loss", "Loss/value_loss", "Grads/global_norm"]


def make_train_step(agent: A2CAgent, optimizer: torch.optim.Optimizer, cfg):
    """Build the update: ``update(data) -> metrics``.

    ``data`` holds ``obs`` (a dict), ``actions``, ``returns`` and
    ``advantages``, ``[N, ...]`` tensors on the device.  The agent and the
    optimizer update in place.  ``metrics`` is one float32 vector: the
    policy and value losses and the gradient's global norm before
    clipping, 1 if the step was not finite, then the health stats
    (``update.health_names``: the gradients, the update as the applied
    delta, the parameters before it; ``value_ev`` of the rollout's values,
    ``returns - advantages``, against its returns)."""
    sentinel, health = sentinel_spec(cfg), health_spec(cfg)
    cdt = compute_dtype_of(cfg)
    max_grad_norm = float(cfg.algo.max_grad_norm or 0.0)
    reduction, vf_coef = str(cfg.algo.loss_reduction), float(cfg.algo.vf_coef)
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

    def update(data: Dict[str, Any]) -> torch.Tensor:
        if sentinel.skip_update:
            with torch.no_grad():
                torch._foreach_copy_(snapshot, guarded)
        _, logprobs, _, values = call_cast(
            (agent,), cdt, lambda: agent(cast_floating(data["obs"], cdt), actions=data["actions"]))
        advantages = data["advantages"]
        if cfg.algo.get("normalize_advantages", False):
            advantages = (advantages - advantages.mean()) / (advantages.std(unbiased=False) + 1e-8)
        pg = policy_loss(logprobs, advantages, reduction)
        v = value_loss(values.float(), data["returns"], reduction)
        grads = list(torch.autograd.grad(pg + vf_coef * v, params))
        gnorm = global_norm(grads)
        for p, g in zip(params, clip_by_global_norm(grads, max_grad_norm) if max_grad_norm > 0 else grads):
            p.grad = g
        if health.enabled:
            with torch.no_grad():
                for n in names:
                    torch._foreach_copy_(before[n], groups[n])
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        finite = finite_flag(gnorm, pg, v)
        metrics = [torch.stack([pg, v, gnorm, 1.0 - finite.float()]).float().detach()]
        if health.enabled:
            with torch.no_grad():
                by_name = {n: [grads[index[id(p)]] for p in groups[n]] for n in names}
                deltas = {n: torch._foreach_sub(groups[n], before[n]) for n in names}
                # the parameters before the update, as the JAX step's
                stats = health_stats(by_name, deltas, before, unit_dims=unit_dims, per_module=health.per_module,
                                     dead_eps=health.dead_eps)
                ev = explained_variance(data["returns"] - data["advantages"], data["returns"])
            metrics += [torch.stack([stats[k] for k in health_out[:-1]]).float(), ev[None]]
        if sentinel.skip_update:
            select_finite(finite, guarded, snapshot)
        return torch.cat(metrics)

    update.health_names = health_out
    return update


def make_update(agent: A2CAgent, optimizer: torch.optim.Optimizer, cfg, total_iters: int):
    """A2C's update for PPO's loop (``_on_policy_main``): one
    :func:`make_train_step` step an iteration."""
    train_step = make_train_step(agent, optimizer, cfg)

    def update(iter_num: int, data: Dict[str, Any], generator: torch.Generator) -> torch.Tensor:
        return train_step(data)

    update.metric_order = METRIC_ORDER
    update.health_names = train_step.health_names
    update.updates_per_iteration = 1
    update.schedule = False
    return update


@register_algorithm()
def main(runtime, cfg) -> Dict[str, Any]:
    """The A2C loop: PPO's (``_on_policy_main``) with A2C's agent and
    update.  ``checkpoint.resume_from`` restores the agent, the optimizer's
    state (either package's, optax's ``rmsprop`` layout) and the counters."""
    return _on_policy_main(runtime, cfg, build_agent, make_update)
