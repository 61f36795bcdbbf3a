"""DreamerV3-JEPA agent (counterpart of
``sheeprl_tpu/algos/dreamer_v3_jepa/agent.py``): DreamerV3's four modules
and the JEPA heads, the online projector and predictor and their targets.

The target encoder is a copy of the world model's encoders (the JAX
package's ``encoder_subtree``) and the target projector one of the
projector; both follow the online ones by an exponential moving average
and are never trained.  The world-model optimizer trains the world model,
the projector and the predictor together, and the checkpoint holds the
heads as the JAX package's ``jepa`` tree.
"""

from __future__ import annotations

import copy
from math import prod
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence

import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import Actor, Agent, Critic, WorldModel, build_agent as build_dv3_agent
from sheeprl_tpu_torch.models.blocks import lecun_normal_
from sheeprl_tpu_torch.models.jepa import JEPAPredictor, JEPAProjector


class TargetEncoder(nn.Module):
    """A copy of a world model's encoders, encoding as the world model does."""

    def __init__(self, world_model: WorldModel):
        super().__init__()
        self.cnn_encoder = copy.deepcopy(world_model.cnn_encoder)
        self.mlp_encoder = copy.deepcopy(world_model.mlp_encoder)

    encode = WorldModel.encode


class JEPAHeads(nn.Module):
    """The online projector and predictor (trained with the world model) and
    the target encoder and projector (moved only by the moving average)."""

    def __init__(self, world_model: WorldModel, embed_dim: int, proj_dim: int, hidden: int):
        super().__init__()
        self.projector = JEPAProjector(embed_dim, proj_dim, hidden)
        self.predictor = JEPAPredictor(proj_dim, hidden)
        self.target_encoder = TargetEncoder(world_model)
        self.target_projector = copy.deepcopy(self.projector)

    def online(self) -> List[nn.Parameter]:
        return list(self.projector.parameters()) + list(self.predictor.parameters())


class JEPAAgent(NamedTuple):
    """DreamerV3's four module trees and the JEPA heads."""

    world_model: WorldModel
    actor: Actor
    critic: Critic
    target_critic: Critic
    jepa: JEPAHeads

    optimizer_configs = Agent.optimizer_configs
    initial_moments = Agent.initial_moments

    def parameters_of(self, name: str) -> List[nn.Parameter]:
        """What the optimizer ``name`` trains: the world-model optimizer the
        world model, then the projector and the predictor."""
        own = list(getattr(self, name).parameters())
        return own + self.jepa.online() if name == "world_model" else own

    def optimizer_spec(self, name: str) -> Any:
        """:meth:`parameters_of` ``name`` in the flax layout its optax state
        follows; the world model's is optax's tuple of the world-model tree
        and ``{projector, predictor}``."""
        from sheeprl_tpu_torch.interop.flax_params import jepa_spec, param_spec

        spec = param_spec(*self[:4])[name]
        if name != "world_model":
            return spec
        heads = jepa_spec(self.jepa)
        return [spec, {"projector": heads["projector"], "predictor": heads["predictor"]}]

    def trees(self) -> Dict[str, Any]:
        """The JAX package's four flax trees and its ``jepa`` tree (numpy)."""
        from sheeprl_tpu_torch.interop.flax_params import jepa_to_flax, to_flax

        return {**to_flax(*self[:4]), "jepa": jepa_to_flax(self.jepa)}


def build_agent(actions_dim: Sequence[int], is_continuous: bool, cfg, obs_space,
                state: Optional[Mapping[str, Any]] = None, device: torch.device | str = "cpu") -> JEPAAgent:
    """DreamerV3's agent (``state``'s four trees, or the seed), then the
    heads: the projector's input width probed from the encoder, as the JAX
    package does; the projector and predictor from flax's default
    initialisation seeded by ``cfg.seed + 1``, the targets copies of the
    online modules; all of it from ``state["jepa"]`` when the checkpoint
    has one."""
    trees = None if state is None else {k: state[k] for k in ("world_model", "actor", "critic", "target_critic")}
    agent = build_dv3_agent(actions_dim, is_continuous, cfg, obs_space, trees, "cpu")
    sample = {k: torch.zeros((1, 1) + tuple(obs_space[k].shape)) for k in cfg.algo.cnn_keys.encoder}
    sample.update({k: torch.zeros((1, 1, int(prod(obs_space[k].shape)))) for k in cfg.algo.mlp_keys.encoder})
    with torch.no_grad():
        embed_dim = int(agent.world_model.encode(sample).shape[-1])
    heads = JEPAHeads(agent.world_model, embed_dim, int(cfg.algo.jepa_proj_dim), int(cfg.algo.jepa_hidden))
    generator = torch.Generator().manual_seed(int(cfg.seed or 0) + 1)
    lecun_normal_(heads.projector, generator)
    lecun_normal_(heads.predictor, generator)
    heads.target_projector.load_state_dict(heads.projector.state_dict())
    if state is not None and "jepa" in state:
        from sheeprl_tpu_torch.interop.flax_params import jepa_from_flax

        jepa_from_flax(state["jepa"], heads)
    heads.target_encoder.requires_grad_(False)
    heads.target_projector.requires_grad_(False)
    return JEPAAgent(*(m.to(device) for m in agent), heads.to(device))
