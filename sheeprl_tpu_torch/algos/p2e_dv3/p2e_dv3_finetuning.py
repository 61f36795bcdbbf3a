"""Plan2Explore-DV3 finetuning (counterpart of
``sheeprl_tpu/algos/p2e_dv3/p2e_dv3_finetuning.py``): DreamerV3's loop and
gradient step, started from an exploration checkpoint
(``checkpoint.exploration_ckpt_path``).

The world model and the task actor and critic come from the exploration
run, with their optimizer states and the task's Moments; the model and
env fields that must match it come from its archived ``config.yaml``; with
``buffer.load_from_exploration`` its replay too.  The player acts with the
exploration actor until the first gradient step, then with the task actor
(``algo.player.actor_type=task``: from the start).  A finetuning
checkpoint holds DreamerV3's four trees and ``actor_exploration``, as the
JAX package writes it, and resumes as DreamerV3's does.
"""

from __future__ import annotations

import pathlib
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence

import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    Actor,
    Agent,
    Critic,
    WorldModel,
    build_agent as build_dv3_agent,
    init_weights,
    make_actor,
)
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import _dreamer_main, make_train_step
from sheeprl_tpu_torch.utils.registry import register_algorithm

DV3_TREES = ("world_model", "actor", "critic", "target_critic")


def load_exploration_cfg(cfg):
    """The exploration run's config, archived two levels up from
    ``checkpoint.exploration_ckpt_path``, its targets the port's."""
    from sheeprl_tpu_torch.cli import _archived_config

    return _archived_config(pathlib.Path(cfg.checkpoint.exploration_ckpt_path))


def apply_exploration_cfg(cfg, exploration_cfg) -> None:
    """Copy the model and env fields that must match the exploration run;
    the env must be the exploration's.  With ``buffer.load_from_exploration``
    (and a replay in the exploration checkpoint) the number of envs too."""
    if exploration_cfg.env.id != cfg.env.id:
        raise ValueError("Finetuning must use the exploration environment: "
                         f"got '{cfg.env.id}', exploration used '{exploration_cfg.env.id}'")
    for k in ("gamma", "lmbda", "horizon", "layer_norm", "dense_units", "mlp_layers", "dense_act", "cnn_act", "unimix",
              "hafner_initialization", "world_model", "actor", "critic", "cnn_keys", "mlp_keys"):
        if k in exploration_cfg.algo:
            cfg.algo[k] = exploration_cfg.algo[k]
    for k in ("screen_size", "action_repeat", "grayscale", "clip_rewards", "frame_stack_dilation", "max_episode_steps",
              "reward_as_observation"):
        if k in exploration_cfg.env:
            cfg.env[k] = exploration_cfg.env[k]
    if cfg.buffer.get("load_from_exploration") and exploration_cfg.buffer.checkpoint:
        cfg.env.num_envs = exploration_cfg.env.num_envs


def finetuning_state(state: Mapping[str, Any]) -> Dict[str, Any]:
    """A checkpoint as the finetuning loop reads it: a finetuning
    checkpoint as it is; an exploration checkpoint's task trees, their
    optimizer states and the task's Moments under DreamerV3's names, with
    ``actor_exploration`` and the replay.  The Plan2Explore families on
    DreamerV2 and V1 share it: their exploration checkpoints hold no
    Moments, and DreamerV1's no target critic."""
    if "actor" in state:
        return dict(state)
    opt_states = state["opt_states"]
    out = {
        "world_model": state["world_model"], "actor": state["actor_task"], "critic": state["critic_task"],
        "actor_exploration": state["actor_exploration"],
        "opt_states": {"world_model": opt_states["world_model"], "actor": opt_states["actor_task"],
                       "critic": opt_states["critic_task"]},
        "rb": state.get("rb"),
    }
    if "target_critic_task" in state:
        out["target_critic"] = state["target_critic_task"]
    if "task" in (state.get("moments") or {}):
        out["moments"] = state["moments"]["task"]
    return out


def _task_modules(agent) -> List[nn.Module]:
    return [getattr(agent, k) for k in agent._fields if k != "actor_exploration"]


def finetuning_optimizer_spec(agent, name: str) -> Any:
    """A finetuning agent's (the task's trees and ``actor_exploration``)
    optimizer spec: the task's, as the Dreamer family's agent lays it out."""
    from sheeprl_tpu_torch.interop.flax_params import param_spec

    return param_spec(*_task_modules(agent))[name]


def finetuning_trees(agent) -> Dict[str, Any]:
    """The task's trees and ``actor_exploration``, as the JAX finetuning
    loops checkpoint them (DreamerV3's, V2's or V1's)."""
    from sheeprl_tpu_torch.interop.flax_params import actor_spec, dump_trees, param_spec

    return dump_trees({**param_spec(*_task_modules(agent)), "actor_exploration": actor_spec(agent.actor_exploration)})


class FinetuningAgent(NamedTuple):
    """DreamerV3's four modules, trained, and the exploration actor, which
    only acts."""

    world_model: WorldModel
    actor: Actor
    critic: Critic
    target_critic: Critic
    actor_exploration: Actor

    optimizer_configs = Agent.optimizer_configs
    initial_moments = Agent.initial_moments
    parameters_of = Agent.parameters_of
    optimizer_spec = finetuning_optimizer_spec
    trees = finetuning_trees


def build_agent(actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space,
                state: Optional[Mapping[str, Any]] = None, device: torch.device | str = "cpu") -> FinetuningAgent:
    """DreamerV3's agent and the exploration actor, from ``state``
    (:func:`finetuning_state`'s layout) or from the seed."""
    dv3 = build_dv3_agent(actions_dim, is_continuous, cfg, obs_space,
                          None if state is None else {k: state[k] for k in DV3_TREES}, "cpu")
    actor_exploration = make_actor(actions_dim, is_continuous, cfg)
    init_weights(None, actor_exploration, None, torch.Generator().manual_seed(int(cfg.seed or 0) + 17))
    if state is not None:
        from sheeprl_tpu_torch.interop.flax_params import actor_spec, load_trees

        load_trees({"actor_exploration": actor_spec(actor_exploration)}, state)
    modules: List[nn.Module] = [*dv3, actor_exploration]
    return FinetuningAgent(*(m.to(device) for m in modules))


def player_actor(cfg):
    """The exploration actor until the first gradient step, the task actor
    from then on (from the start with ``algo.player.actor_type=task``)."""
    task_only = cfg.algo.player.get("actor_type", "exploration") == "task"
    return lambda has_trained: "actor" if has_trained or task_only else "actor_exploration"


@register_algorithm()
def main(runtime, cfg) -> Dict[str, Any]:
    """The finetuning loop: DreamerV3's, from the exploration checkpoint
    when not resuming."""
    apply_exploration_cfg(cfg, load_exploration_cfg(cfg))
    return _dreamer_main(
        runtime, cfg, build_agent, make_train_step,
        load_agent_state_fn=lambda runtime, cfg: finetuning_state(runtime.load(cfg.checkpoint.exploration_ckpt_path)),
        player_actor_fn=player_actor(cfg),
    )
