"""SAC losses (counterpart of ``sheeprl_tpu/algos/sac/loss.py``), and the
conservative Q penalty that the offline mode's SAC and DroQ critic losses
add (``algo.offline.cql_alpha > 0``)."""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def critic_loss(qf_values: torch.Tensor, next_qf_value: torch.Tensor) -> torch.Tensor:
    """The sum over the critics (the last axis) of each one's MSE against
    the shared soft target."""
    return ((qf_values - next_qf_value) ** 2).mean(dim=tuple(range(qf_values.dim() - 1))).sum()


def policy_loss(alpha: torch.Tensor, logprobs: torch.Tensor, min_qf_values: torch.Tensor) -> torch.Tensor:
    """``mean(alpha * log_pi - Q)``."""
    return (alpha * logprobs - min_qf_values).mean()


def entropy_loss(log_alpha: torch.Tensor, logprobs: torch.Tensor, target_entropy: float) -> torch.Tensor:
    """The entropy coefficient's loss, the log-probs held constant."""
    return (-log_alpha * (logprobs.detach() + target_entropy)).mean()


def conservative_q_penalty(
    obs_c: torch.Tensor,
    qf_values: torch.Tensor,
    actor_sample: Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    critic_apply: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    uniform_actions: torch.Tensor,
    policy_eps: torch.Tensor,
) -> torch.Tensor:
    """The simplified CQL(H) term of the JAX package's offline critic
    losses: the logsumexp of Q over ``n`` uniform and ``n`` fresh policy
    action proposals, minus the dataset's Q, averaged; it pushes Q down on
    actions outside the data and up on the data's.

    The draws come pre-drawn, as every sampler of the port takes its noise:
    ``uniform_actions`` ``[n, B, A]`` already in the action bounds (the JAX
    ``uniform(k_unif, ..., minval=low, maxval=high)``), ``policy_eps``
    ``[n, B, A]`` standard normals, one per proposal (the JAX actor's draw
    under each of ``split(k_pol, n)``).  ``actor_sample(obs, eps) ->
    (actions, logprobs)`` and ``critic_apply(obs, actions) -> [..., N]``
    run their modules in the compute dtype; ``qf_values`` is the fp32
    dataset Q the caller computed.  The policy proposals carry no gradient.
    """
    n = uniform_actions.shape[0]
    obs_n = obs_c.expand(n, *obs_c.shape)
    with torch.no_grad():
        pol_actions, _ = actor_sample(obs_n, policy_eps)
    proposals = torch.cat([uniform_actions.to(obs_c.dtype), pol_actions.detach()], dim=0)
    q_prop = critic_apply(obs_c.expand(2 * n, *obs_c.shape), proposals).float()
    return (torch.logsumexp(q_prop, dim=0) - qf_values).mean()
