"""DroQ training (counterpart of ``sheeprl_tpu/algos/droq/droq.py``): SAC
with dropout critics and a high replay ratio (20 gradient steps a policy
step by default).

Each gradient step, as the JAX step orders it: the soft target from the
deterministic target critic; the critic update on the summed per-member
MSE under one optimizer, each member with its own dropout masks; the
Polyak average of the target critic; then the actor and the entropy
coefficient on a second sampled batch, the actor against the **mean** over
the critics (a second set of dropout masks), not their minimum.  The draws
of a step, in the JAX step's split order: the next action's normal noise,
the critic's masks, the actor's noise, the actor pass's masks.  The JAX
step computes no health stats and applies no ``skip_update`` selection;
neither does the port, and ``run exp=droq`` refuses
``diagnostics.sentinel.policy=skip_update``.  With
``algo.offline.cql_alpha > 0`` the critic loss adds the conservative Q
penalty, its proposals through the deterministic critic pass (no masks),
as the JAX step's; its draws come after the step's own.  The metric vector
is the mean ``[qf, actor, alpha]`` over the call's gradient steps, then the
count of steps with a non-finite loss.  The loop is SAC's (``algos/sac/sac.py``),
serialized as the JAX DroQ loop is: the envs step, then the gradient steps.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from sheeprl_tpu_torch.algos.droq.agent import build_agent
from sheeprl_tpu_torch.algos.sac.loss import conservative_q_penalty, entropy_loss, policy_loss
from sheeprl_tpu_torch.algos.sac.sac import (SACFamily, apply_gradients, cql_spec, draw_cql_noise, off_policy_main,
                                             polyak_, spec_tensors)
from sheeprl_tpu_torch.parallel.dp import local_sample_size, pmean_tree, run_one, run_shards, stage
from sheeprl_tpu_torch.parallel.precision import call_cast, compute_dtype_of
from sheeprl_tpu_torch.utils.registry import register_algorithm

METRIC_ORDER = ["Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss"]


def make_train_step(agent, optimizers: Dict[str, torch.optim.Optimizer], cfg, target_entropy: float):
    """Build the gradient steps: ``update(data, actor_data, noise) ->
    metrics``.

    ``data`` holds ``observations``, ``next_observations``, ``actions``,
    ``rewards`` and ``terminated``, ``actor_data`` ``observations`` of the
    second batch, ``[G, B, ...]`` tensors on the device; ``noise`` holds
    ``eps_next`` and ``eps_actor`` (``[G, B, A]`` standard normals) and
    ``masks_critic`` and ``masks_actor`` (per hidden layer a ``[G, N, B, H]``
    boolean keep-mask), and with ``cql_alpha > 0`` ``cql_uniform`` and
    ``cql_eps`` (``[G, n, B, A]``, ``sac.py::draw_cql_noise``)."""
    from sheeprl_tpu_torch.interop.flax_params import sac_spec

    cdt = compute_dtype_of(cfg)
    gamma, tau = float(cfg.algo.gamma), float(cfg.algo.tau)
    actor, critic, target = agent.actor, agent.critic, agent.target_critic
    cql_alpha, cql_samples = cql_spec(cfg, actor)
    spec = sac_spec(agent)
    actor_params, critic_params = spec_tensors(spec["actor"]), spec_tensors(spec["critic"])
    target_params = spec_tensors(spec["target_critic"])

    def one_step(batch, actor_obs, eps_next, masks, eps_actor, masks_actor, cql):
        """One gradient step on one shard's blocks (a generator: the
        gradients are reduced over the shards, as the JAX step pmeans them)."""
        obs_c, next_obs_c = batch["observations"].to(cdt), batch["next_observations"].to(cdt)
        actor_obs_c = actor_obs.to(cdt)
        with torch.no_grad():
            next_actions, next_logprobs = call_cast(
                (actor,), cdt, lambda: actor.sample_and_log_prob(next_obs_c, eps_next), buffers=False)
            next_q = call_cast((target,), cdt, lambda: target(next_obs_c, next_actions)).float()
            next_qf_value = batch["rewards"] + (1 - batch["terminated"]) * gamma * (
                next_q.min(dim=-1, keepdim=True).values - agent.log_alpha.exp() * next_logprobs.float())
        qf_values = call_cast((critic,), cdt, lambda: critic(obs_c, batch["actions"].to(cdt), masks)).float()
        qf_l = ((qf_values - next_qf_value) ** 2).mean(dim=tuple(range(qf_values.dim() - 1))).sum()
        if cql_alpha > 0:
            qf_l = qf_l + cql_alpha * conservative_q_penalty(
                obs_c, qf_values,
                lambda o, e: call_cast((actor,), cdt, lambda: actor.sample_and_log_prob(o, e), buffers=False),
                lambda o, a: call_cast((critic,), cdt, lambda: critic(o, a)),
                cql[0], cql[1])
        grads = yield from pmean_tree(torch.autograd.grad(qf_l, critic_params))
        apply_gradients(optimizers["critic"], critic_params, grads)
        polyak_(target_params, critic_params, tau)

        actions, logprobs = call_cast((actor,), cdt, lambda: actor.sample_and_log_prob(actor_obs_c, eps_actor),
                                      buffers=False)
        q = call_cast((critic,), cdt, lambda: critic(actor_obs_c, actions, masks_actor)).float()
        actor_l = policy_loss(agent.log_alpha.detach().exp(), logprobs.float(), q.mean(dim=-1, keepdim=True))
        grads = yield from pmean_tree(torch.autograd.grad(actor_l, actor_params))
        apply_gradients(optimizers["actor"], actor_params, grads)

        alpha_l = entropy_loss(agent.log_alpha, logprobs, target_entropy)
        grads = yield from pmean_tree(torch.autograd.grad(alpha_l, [agent.log_alpha]))
        apply_gradients(optimizers["alpha"], [agent.log_alpha], grads)
        return torch.stack([qf_l.float(), actor_l.float(), alpha_l.float()]).detach()

    def body(data: Dict[str, torch.Tensor], actor_data: Dict[str, torch.Tensor], noise: Dict[str, Any]):
        """The gradient steps on one shard's blocks (a generator whose
        collectives :func:`~sheeprl_tpu_torch.parallel.dp.run_shards`
        answers); the steps' losses are reduced over the shards, so every
        shard counts the same non-finite steps."""
        rows = []
        for g in range(noise["eps_next"].shape[0]):
            rows.append((yield from one_step(
                {k: v[g] for k, v in data.items()}, actor_data["observations"][g], noise["eps_next"][g],
                [m[g] for m in noise["masks_critic"]], noise["eps_actor"][g], [m[g] for m in noise["masks_actor"]],
                (noise["cql_uniform"][g], noise["cql_eps"][g]) if cql_alpha > 0 else None)))
        flat = yield from pmean_tree(torch.stack(rows))
        nonfinite = (~torch.isfinite(flat).all(dim=1)).float().sum()
        return torch.cat([flat.mean(dim=0), nonfinite[None]])

    def update(data: Dict[str, torch.Tensor], actor_data: Dict[str, torch.Tensor],
               noise: Dict[str, Any]) -> torch.Tensor:
        """One shard: the whole batches on this agent's device."""
        return run_one(body(data, actor_data, noise))

    update.body = body
    update.health_names = []
    update.cql_samples = cql_samples if cql_alpha > 0 else 0
    return update


def draw_noise(agent, gradient_steps: int, batch_size: int, act_dim: int, generator: torch.Generator,
               device, cql_samples: int = 0) -> Dict[str, Any]:
    """The draws of ``gradient_steps`` steps for :func:`make_train_step`;
    with ``cql_samples`` the conservative penalty's proposals after them."""

    def masks():
        drawn = agent.critic.draw_masks(gradient_steps * batch_size, generator, device)
        # [N, G * B, H] -> [G, N, B, H]
        return [m.reshape(m.shape[0], gradient_steps, batch_size, -1).transpose(0, 1) for m in drawn]

    shape = (gradient_steps, batch_size, act_dim)
    eps_next = torch.randn(shape, generator=generator, device=device)
    masks_critic = masks()
    eps_actor = torch.randn(shape, generator=generator, device=device)
    out = {"eps_next": eps_next, "masks_critic": masks_critic, "eps_actor": eps_actor, "masks_actor": masks()}
    if cql_samples:
        cql = draw_cql_noise(agent.actor, gradient_steps, cql_samples, batch_size, generator, device)
        out.update(cql_uniform=cql["uniform"], cql_eps=cql["eps"])
    return out


class DroQFamily(SACFamily):
    """DroQ's parts of the off-policy loop: SAC's, with DroQ's critics,
    ``next_observations`` always stored, two batches a call and no
    ``skip_update``."""

    name = "DroQ"
    metric_order = METRIC_ORDER
    pipelined = False
    skip_update = False
    registers_models = False

    def build(self, cfg, obs_space, action_space, state, device):
        return build_agent(cfg, obs_space, action_space, state["agent"] if state else None, device)

    def sample_next_obs(self) -> bool:
        return False

    def make_update(self):
        self.update = make_train_step(self.agent, self.optimizers, self.cfg, self.target_entropy)
        self.health_names = []
        self.cql_samples = self.update.cql_samples
        self.step = self.dp_step
        return self

    def dp_step(self, data: Dict[str, torch.Tensor], generator: torch.Generator) -> torch.Tensor:
        """The gradient steps over the shards: shard d's on its blocks d of
        both batches with draws from its own random stream (shard 0's is
        ``generator``), as the JAX step folds its key per device."""
        gradient_steps, rows = data["actions"].shape[:2]
        rows //= len(self.shards)
        generators = [generator, *(self.generators or [])[1:]]
        bodies = []
        for shard, block, g in zip(self.shards, stage(data, [s.device for s in self.shards], batch_axis=1),
                                   generators):
            actor_data = {"observations": block.pop("actor_observations")}
            noise = draw_noise(shard.agent, gradient_steps, rows, self.act_dim, g, shard.device, self.cql_samples)
            bodies.append(shard.update.body(block, actor_data, noise))
        return run_shards(bodies)[0]

    def train(self, rb, batch_size: int, gradient_steps: int, generator: torch.Generator, inject) -> torch.Tensor:
        """``gradient_steps`` steps on two batches of ``batch_size`` rows a
        shard, each drawn at once for every shard."""
        rows = local_sample_size(batch_size * len(self.shards))
        sample = rb.sample(batch_size=rows, n_samples=gradient_steps)
        actor_sample = rb.sample(batch_size=rows, n_samples=gradient_steps)
        data = self.stager({**{k: np.asarray(sample[k], np.float32) for k in
                               ("observations", "next_observations", "actions", "rewards", "terminated")},
                            "actor_observations": np.asarray(actor_sample["observations"], np.float32)})
        return self.step(inject(data), generator)


@register_algorithm()
def main(runtime, cfg) -> Dict[str, Any]:
    """The DroQ loop (``algos/sac/sac.py::off_policy_main`` with
    :class:`DroQFamily`)."""
    return off_policy_main(runtime, cfg, DroQFamily)
