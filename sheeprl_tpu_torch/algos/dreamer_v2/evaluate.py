"""DreamerV2 evaluation (counterpart of
``sheeprl_tpu/algos/dreamer_v2/evaluate.py``): one test episode of a
checkpoint's policy, sampled (``greedy=False``), its reward logged."""

from __future__ import annotations

from typing import Any, Callable, Dict

from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerDV3
from sheeprl_tpu_torch.algos.dreamer_v3.utils import test
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.env import make_env
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.registry import register_evaluation


def evaluate_dreamer(build_agent_fn: Callable, runtime, cfg, state: Dict[str, Any]) -> float:
    """The test episode of the agent ``build_agent_fn(actions_dim,
    is_continuous, cfg, obs_space, state, device)`` builds from a checkpoint
    of either package; returns its cumulative reward."""
    logger = get_logger(runtime, cfg)
    log_dir = get_log_dir(runtime, cfg.root_dir, cfg.run_name)
    env = make_env(cfg, cfg.seed, 0, log_dir, "test")()
    action_space, observation_space = env.action_space, env.observation_space
    env.close()
    is_continuous = isinstance(action_space, spaces.Box)
    is_multidiscrete = isinstance(action_space, spaces.MultiDiscrete)
    actions_dim = tuple(
        int(a) for a in (action_space.shape if is_continuous
                         else (action_space.nvec.tolist() if is_multidiscrete else [action_space.n]))
    )
    agent = build_agent_fn(actions_dim, is_continuous, cfg, observation_space, state, runtime.device)
    player = PlayerDV3(agent.world_model, agent.actor, actions_dim, 1)
    generator = runtime.seed_everything(cfg.seed)
    cumulative_rew, _ = test(player, cfg, log_dir, generator, greedy=False)
    logger.log_metrics({"Test/cumulative_reward": cumulative_rew}, 0)
    logger.finalize()
    return cumulative_rew


@register_evaluation(algorithms="dreamer_v2")
def evaluate_dreamer_v2(runtime, cfg, state: Dict[str, Any]) -> float:
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import build_dreamer_v2_agent

    # the JAX evaluation reads a checkpoint without the target critic too
    state = {**state, "target_critic": state.get("target_critic", state["critic"])}
    return evaluate_dreamer(build_dreamer_v2_agent, runtime, cfg, state)
