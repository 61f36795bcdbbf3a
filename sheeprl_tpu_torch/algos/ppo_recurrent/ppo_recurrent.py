"""Recurrent PPO training (counterpart of
``sheeprl_tpu/algos/ppo_recurrent/ppo_recurrent.py``): the update over
sequence minibatches, and PPO's loop (``algos/ppo/ppo.py::_on_policy_main``)
with the recurrent family's rollout and data.

The rollout carries each env's LSTM state and previous action, zeroed on
done before the next policy step (``algo.reset_recurrent_state_on_done``),
and stores with every step the state it started from and the reset mask.
The rollout ``[T, N]`` is cut into ``T / L`` sequences per env of ``L =
algo.per_rank_sequence_length`` steps (``[L, S]``, ``S = T / L * N``), each
starting from its stored state at its first step; GAE runs over the rollout
with the value of the observations it ended on.  The update follows the JAX
package's ``make_train_step``: for each of ``algo.update_epochs`` epochs a
permutation of the sequences (injected by tests), cut into
``algo.per_rank_num_batches`` minibatches ``[L, S_mb]``; per minibatch the
clipped policy loss, the value loss (clipped with ``algo.clip_vloss``) and
the entropy bonus, with the resets masked inside the sequence forward (the
agent and the observations cast to the compute dtype of
``fabric.precision``), the gradient clipped by ``algo.max_grad_norm`` and
one ``adamw`` step; with ``algo.anneal_lr`` its rate is optax's
``linear_schedule`` to 0 over every minibatch update of the run, as PPO's
(``algos/ppo/ppo.py::lr_setter``).  The metric vector is the three losses' means over the
minibatches and the non-finite minibatch count.  The JAX step computes no
health stats and applies no ``skip_update`` selection, so neither does this
one, and ``run`` refuses ``diagnostics.sentinel.policy=skip_update``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.loss import entropy_loss, policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.ppo import OnPolicyFamily, _on_policy_main, linear_schedule, lr_setter
from sheeprl_tpu_torch.algos.ppo_recurrent.agent import RecurrentPPOAgent, build_agent, prev_actions_of
from sheeprl_tpu_torch.algos.ppo_recurrent.utils import test
from sheeprl_tpu_torch.diagnostics.sentinel import finite_flag, sentinel_spec
from sheeprl_tpu_torch.parallel.precision import call_cast, cast_floating, compute_dtype_of
from sheeprl_tpu_torch.utils.optim import clip_by_global_norm
from sheeprl_tpu_torch.utils.registry import register_algorithm

METRIC_ORDER = ["Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss"]


def sequence_layout(cfg) -> tuple:
    """``(num_sequences, seq_batch, num_minibatches)`` of a rollout, as the
    JAX loop cuts it; raises where it cannot."""
    rollout_steps, seq_len = int(cfg.algo.rollout_steps), cfg.algo.per_rank_sequence_length
    if not seq_len or seq_len <= 0:
        raise ValueError(f"per_rank_sequence_length must be positive, got {seq_len}")
    if rollout_steps % seq_len != 0:
        raise ValueError(f"rollout_steps ({rollout_steps}) must be a multiple of per_rank_sequence_length ({seq_len})")
    num_sequences = (rollout_steps // seq_len) * int(cfg.env.num_envs)
    seq_batch = max(1, num_sequences // max(1, int(cfg.algo.get("per_rank_num_batches", 4))))
    return num_sequences, seq_batch, num_sequences // seq_batch


def to_sequences(x: torch.Tensor, seq_len: int) -> torch.Tensor:
    """``[T, N, ...]`` -> ``[L, S, ...]``: sequence ``c * N + n`` is env
    ``n``'s steps ``[c * L, (c + 1) * L)``."""
    T, N = x.shape[:2]
    chunks = T // seq_len
    return (x.reshape(chunks, seq_len, N, *x.shape[2:]).transpose(1, 2)
            .reshape(chunks * N, seq_len, *x.shape[2:]).transpose(0, 1))


def make_train_step(agent: RecurrentPPOAgent, optimizer: torch.optim.Optimizer, cfg, num_minibatches: int,
                    seq_batch: int, schedule=None):
    """Build the update: ``update(data, perms, coefs) -> metrics``.

    ``data`` holds ``obs`` (a dict), ``prev_actions``, ``actions``,
    ``logprobs``, ``values``, ``returns``, ``advantages``, ``resets`` as
    ``[L, S, ...]`` tensors and ``hx0``/``cx0`` ``[S, H]``; ``perms`` the
    ``update_epochs`` permutations of ``range(num_minibatches *
    seq_batch)``; ``coefs`` ``(clip, entropy, value)``.  The agent and the
    optimizer update in place; ``schedule`` (optax's linear schedule, or
    None) sets the rate before each step."""
    cdt = compute_dtype_of(cfg)
    epochs = int(cfg.algo.update_epochs)
    max_grad_norm = float(cfg.algo.max_grad_norm or 0.0)
    params = [p for group in optimizer.param_groups for p in group["params"]]
    set_lr = lr_setter(optimizer, schedule) if schedule is not None else None

    def loss_fn(mb: Dict[str, Any], clip_coef: float, ent_coef: float, vf_coef: float):
        _, new_logprobs, entropy, new_values, _ = call_cast((agent,), cdt, lambda: agent(
            cast_floating(mb["obs"], cdt), mb["prev_actions"].to(cdt), mb["hx0"].to(cdt), mb["cx0"].to(cdt),
            resets=mb["resets"], actions=mb["actions"]))
        advantages = mb["advantages"]
        if cfg.algo.normalize_advantages:
            advantages = (advantages - advantages.mean()) / (advantages.std(unbiased=False) + 1e-8)
        pg = policy_loss(new_logprobs, mb["logprobs"], advantages, clip_coef, "mean")
        v = value_loss(new_values.float(), mb["values"], mb["returns"], clip_coef, cfg.algo.clip_vloss, "mean")
        e = entropy_loss(entropy, cfg.algo.loss_reduction)
        return pg + vf_coef * v + ent_coef * e, (pg, v, e)

    def update(data: Dict[str, Any], perms: Sequence[torch.Tensor], coefs: Sequence[float]) -> torch.Tensor:
        clip_coef, ent_coef, vf_coef = (float(c) for c in coefs)
        rows = []
        for epoch in range(epochs):
            for idx in perms[epoch].to(params[0].device).reshape(num_minibatches, seq_batch):
                mb = {k: ({kk: vv[:, idx] for kk, vv in v.items()} if isinstance(v, dict)
                          else v[idx] if k in ("hx0", "cx0") else v[:, idx]) for k, v in data.items()}
                total, aux = loss_fn(mb, clip_coef, ent_coef, vf_coef)
                grads = list(torch.autograd.grad(total, params))
                for p, g in zip(params, clip_by_global_norm(grads, max_grad_norm) if max_grad_norm > 0 else grads):
                    p.grad = g
                if set_lr is not None:
                    set_lr()
                optimizer.step()
                optimizer.zero_grad(set_to_none=True)
                rows.append(torch.stack([*aux, 1.0 - finite_flag(*aux).float()]).float().detach())
        flat = torch.stack(rows)
        return torch.cat([flat[:, :3].mean(dim=0), flat[:, 3:].sum(dim=0)])

    update.health_names = []
    return update


def make_update(agent: RecurrentPPOAgent, optimizer: torch.optim.Optimizer, cfg, total_iters: int):
    """The update for PPO's loop: ``update(iter_num, data, generator) ->
    metrics`` on this iteration's annealed clip and entropy coefficients
    and permutations drawn from ``generator``, with ``algo.anneal_lr``
    optax's linear schedule over every minibatch update of the run (the
    JAX loop's ``transition_steps``)."""
    from sheeprl_tpu_torch.utils.utils import polynomial_decay

    _, seq_batch, num_minibatches = sequence_layout(cfg)
    epochs = int(cfg.algo.update_epochs)
    schedule = None
    if cfg.algo.anneal_lr:
        schedule = linear_schedule(optimizer.param_groups[0]["lr"], 0.0, max(1, total_iters * epochs * num_minibatches))
    train_step = make_train_step(agent, optimizer, cfg, num_minibatches, seq_batch, schedule)
    initial_ent, initial_clip = float(cfg.algo.ent_coef), float(cfg.algo.clip_coef)

    def update(iter_num: int, data: Dict[str, Any], generator: torch.Generator) -> torch.Tensor:
        clip_coef, ent_coef = initial_clip, initial_ent
        if cfg.algo.anneal_clip_coef:
            clip_coef = polynomial_decay(iter_num, initial=initial_clip, final=0.0, max_decay_steps=total_iters,
                                         power=1.0)
        if cfg.algo.anneal_ent_coef:
            ent_coef = polynomial_decay(iter_num, initial=initial_ent, final=0.0, max_decay_steps=total_iters,
                                        power=1.0)
        perms = [torch.randperm(num_minibatches * seq_batch, generator=generator, device=data["returns"].device)
                 for _ in range(epochs)]
        return train_step(data, perms, (clip_coef, ent_coef, float(cfg.algo.vf_coef)))

    update.metric_order = METRIC_ORDER
    update.health_names = []
    update.updates_per_iteration = epochs * num_minibatches
    update.schedule = schedule is not None
    return update


class RecurrentFamily(OnPolicyFamily):
    """Recurrent PPO's parts of PPO's loop: the rollout carrying the LSTM
    state across iterations, the sequence data, the flax tree, the test."""

    def __init__(self):
        self.carry = None  # (hx, cx, prev_actions) on the device, prev_dones on the host

    def unported(self, cfg) -> List[str]:
        out = []
        if sentinel_spec(cfg).skip_update:
            out.append("diagnostics.sentinel.policy=skip_update for ppo_recurrent (its JAX step applies no "
                       "selection)")
        return out

    def buffer_size(self, cfg) -> int:
        return int(cfg.algo.rollout_steps)

    def checkpoint_batch_size(self, cfg) -> int:
        return sequence_layout(cfg)[1]

    def spec(self, agent) -> Dict[str, Any]:
        from sheeprl_tpu_torch.interop.flax_params import ppo_recurrent_spec

        return ppo_recurrent_spec(agent)

    def to_flax(self, agent) -> Dict[str, Any]:
        from sheeprl_tpu_torch.interop.flax_params import ppo_recurrent_to_flax

        return ppo_recurrent_to_flax(agent)

    def rollout(self, agent, envs, obs, rb, stage, cfg, generator, aggregator, diag, spaces_of):
        from sheeprl_tpu_torch.algos.ppo.utils import env_actions_of
        from sheeprl_tpu_torch.data.slab import step_slab
        from sheeprl_tpu_torch.envs.player import fetch_values

        num_envs = int(cfg.env.num_envs)
        device = next(agent.parameters()).device
        cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
        obs_keys = cnn_keys + mlp_keys
        if self.carry is None:
            hidden = int(cfg.algo.rnn.lstm.hidden_size)
            zeros = torch.zeros((num_envs, hidden), device=device)
            self.carry = (zeros, zeros.clone(), torch.zeros((num_envs, sum(agent.actions_dim)), device=device),
                          np.zeros((num_envs, 1), np.float32))
        hx, cx, prev_actions, prev_dones = self.carry
        for _ in range(int(cfg.algo.rollout_steps)):
            diag.note_env_steps(num_envs)
            if cfg.algo.reset_recurrent_state_on_done and prev_dones.any():
                keep = torch.from_numpy(1.0 - prev_dones).to(device)
                hx, cx, prev_actions = hx * keep, cx * keep, prev_actions * keep
            hx0, cx0, prev0 = hx, cx, prev_actions
            actions, logprobs, _, values, (hx, cx) = call_cast((agent,), torch.float32, lambda: agent(
                {k: v[None] for k, v in stage(obs, num_envs).items()}, prev0[None], hx0, cx0, generator=generator))
            diag.note_fetch()  # the step's one device-to-host copy
            actions_np, logprobs_np, values_np, hx0_np, cx0_np, prev_np = fetch_values(
                actions[0], logprobs[0], values[0], hx0, cx0, prev0)
            with diag.span("env_step_async"):
                envs.step_async(env_actions_of(actions_np, *spaces_of, num_envs))
            step_data = step_slab(num_envs, {**{k: obs[k] for k in obs_keys}, "actions": actions_np,
                                             "prev_actions": prev_np, "logprobs": logprobs_np, "values": values_np,
                                             "resets": prev_dones, "hx": hx0_np, "cx": cx0_np})
            with diag.span("env_wait"):
                next_obs, rewards, terminated, truncated, info = envs.step_wait()
            dones = np.logical_or(terminated, truncated).reshape(num_envs, 1).astype(np.float32)
            rewards = np.asarray(rewards, dtype=np.float32).reshape(num_envs, 1)
            if cfg.env.clip_rewards:
                rewards = np.tanh(rewards)
            step_data.update(step_slab(num_envs, {"rewards": rewards, "dones": dones}))
            rb.add(step_data, validate_args=cfg.buffer.validate_args)
            if "final_info" in info and "episode" in info["final_info"]:
                ep = info["final_info"]["episode"]
                mask = ep.get("_r", info["final_info"].get("_episode"))
                if mask is not None and np.any(mask):
                    for r, length in zip(ep["r"][mask], ep["l"][mask]):
                        aggregator.update("Rewards/rew_avg", float(r))
                        aggregator.update("Game/ep_len_avg", float(length))
            prev_actions = prev_actions_of(actions[0], agent.actions_dim, agent.is_continuous)
            prev_dones = dones
            obs = next_obs
        self.carry = (hx, cx, prev_actions, prev_dones)
        return obs

    @torch.no_grad()
    def rollout_data(self, agent, rb, obs, stage, cfg, device) -> Dict[str, Any]:
        from sheeprl_tpu_torch.ops.numerics import gae

        rollout_steps, num_envs = int(cfg.algo.rollout_steps), int(cfg.env.num_envs)
        seq_len = int(cfg.algo.per_rank_sequence_length)
        cnn_keys = list(cfg.algo.cnn_keys.encoder)
        obs_keys = cnn_keys + list(cfg.algo.mlp_keys.encoder)
        local = {k: torch.from_numpy(np.ascontiguousarray(rb.buffer[k][:rollout_steps])).to(device) for k in rb.buffer}
        hx, cx, prev_actions, _ = self.carry
        # the bootstrap value from the carry as the rollout left it, as the JAX loop takes it
        next_value = call_cast((agent,), torch.float32, lambda: agent.get_values(
            {k: v[None] for k, v in stage(obs, num_envs).items()}, prev_actions[None], hx, cx))[0]
        returns, advantages = gae(local["rewards"], local["values"], local["dones"], next_value,
                                  float(cfg.algo.gamma), float(cfg.algo.gae_lambda))
        local.update(returns=returns, advantages=advantages)
        data = {"obs": {k: to_sequences(local[k].float(), seq_len) for k in obs_keys}}
        for k in ("prev_actions", "actions", "logprobs", "values", "returns", "advantages", "resets"):
            data[k] = to_sequences(local[k], seq_len)
        data["hx0"] = to_sequences(local["hx"], seq_len)[0]
        data["cx0"] = to_sequences(local["cx"], seq_len)[0]
        return data

    def test(self, agent, env, cfg, device, stager) -> float:
        return test(agent, env, cfg, device, stager)


@register_algorithm()
def main(runtime, cfg) -> Dict[str, Any]:
    """The recurrent PPO loop: PPO's (``_on_policy_main``) with the
    recurrent family's agent, update, rollout and data."""
    sequence_layout(cfg)  # a rollout the loop cannot cut raises before the run starts
    return _on_policy_main(runtime, cfg, build_agent, make_update, RecurrentFamily())
