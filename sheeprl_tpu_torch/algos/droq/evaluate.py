"""DroQ evaluation (counterpart of ``sheeprl_tpu/algos/droq/evaluate.py``):
one greedy test episode of a checkpoint's actor, its reward logged."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.droq.agent import build_agent
from sheeprl_tpu_torch.algos.droq.utils import test
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.env import make_env
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms="droq")
def evaluate_droq(runtime, cfg, state: Dict[str, Any]) -> float:
    """Returns the test episode's cumulative reward; the checkpoint may be
    either package's."""
    logger = get_logger(runtime, cfg)
    log_dir = get_log_dir(runtime, cfg.root_dir, cfg.run_name)
    env = make_env(cfg, cfg.seed, 0, log_dir, "test")()
    if not isinstance(env.observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {env.observation_space}")
    agent, _ = build_agent(cfg, env.observation_space, env.action_space, state["agent"], runtime.device)
    cumulative_rew = test(agent.actor, env, cfg, runtime.device)
    logger.log_metrics({"Test/cumulative_reward": cumulative_rew}, 0)
    logger.finalize()
    return cumulative_rew
