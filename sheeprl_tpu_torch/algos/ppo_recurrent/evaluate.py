"""Recurrent PPO evaluation (counterpart of
``sheeprl_tpu/algos/ppo_recurrent/evaluate.py``): one greedy test episode
of a checkpoint's agent, its reward logged."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.ppo.agent import actions_dim_of
from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent
from sheeprl_tpu_torch.algos.ppo_recurrent.utils import test
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.env import make_env
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms="ppo_recurrent")
def evaluate_ppo_recurrent(runtime, cfg, state: Dict[str, Any]) -> float:
    """Returns the test episode's cumulative reward; the checkpoint may be
    either package's."""
    logger = get_logger(runtime, cfg)
    log_dir = get_log_dir(runtime, cfg.root_dir, cfg.run_name)
    env = make_env(cfg, cfg.seed, 0, log_dir, "test")()
    if not isinstance(env.observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {env.observation_space}")
    actions_dim, is_continuous, _ = actions_dim_of(env.action_space)
    agent = build_agent(actions_dim, is_continuous, cfg, env.observation_space, state["agent"], runtime.device)
    cumulative_rew = test(agent.eval(), env, cfg, runtime.device)
    logger.log_metrics({"Test/cumulative_reward": cumulative_rew}, 0)
    logger.finalize()
    return cumulative_rew
