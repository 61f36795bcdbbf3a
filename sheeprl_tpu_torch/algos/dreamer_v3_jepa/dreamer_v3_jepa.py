"""DreamerV3-JEPA training (counterpart of
``sheeprl_tpu/algos/dreamer_v3_jepa/dreamer_v3_jepa.py``): DreamerV3's loop
and gradient step with a JEPA term on the encoder.

Two masked views of the batch are encoded, one by the online encoder,
projector and predictor, the other by the target encoder and projector;
``jepa_coef`` times their cosine loss joins the world-model loss, and one
optimizer with one global-norm clip trains the world model, the projector
and the predictor.  Right after that update the targets move by the
moving average ``target <- jepa_ema * target + (1 - jepa_ema) * online``
(``optax.incremental_update`` with step ``1 - jepa_ema``).  The step is
DreamerV3's through its ``term`` seam (:class:`JEPATerm`), the loop
DreamerV3's ``_dreamer_main``; the precision policy, the chunked scan and
the diagnostics run as they do for DreamerV3.  The metric vector carries
``Loss/jepa_loss`` after DreamerV3's 11 entries (the JAX package names it
among its aggregator keys), and the health stats count the projector and
predictor as the module ``jepa``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import _dreamer_main
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_train_step as make_dreamer_train_step
from sheeprl_tpu_torch.algos.dreamer_v3_jepa.agent import JEPAAgent, build_agent
from sheeprl_tpu_torch.models.jepa import jepa_loss, make_two_views
from sheeprl_tpu_torch.utils.registry import register_algorithm


class JEPATerm:
    """The JEPA term of the world-model objective (DreamerV3's
    :class:`~sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3.WorldModelTerm`).
    ``noise["views"]`` may hold each vector key's two standard-normal
    draws (:func:`~sheeprl_tpu_torch.models.jepa.make_two_views`)."""

    metric_names = ("Loss/jepa_loss",)

    def __init__(self, agent: JEPAAgent, cfg):
        self.world_model, self.heads = agent.world_model, agent.jepa
        self.modules = (agent.jepa,)
        self.health_groups = {"jepa": agent.jepa.online()}
        self.coef = float(cfg.algo.jepa_coef)
        self.step_size = 1.0 - float(cfg.algo.jepa_ema)
        self.erase_frac = float(cfg.algo.jepa_mask.erase_frac)
        self.vec_dropout = float(cfg.algo.jepa_mask.vec_dropout)
        # each target beside its online module, in the same order
        encoders = [m for m in (agent.world_model.cnn_encoder, agent.world_model.mlp_encoder) if m is not None]
        self.online = [p for m in (*encoders, agent.jepa.projector) for p in m.parameters()]
        self.targets = [p for m in (agent.jepa.target_encoder, agent.jepa.target_projector) for p in m.parameters()]

    def loss(self, batch_obs: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
             noise: Dict[str, Any]) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        obs_q, obs_k = make_two_views(batch_obs, self.erase_frac, self.vec_dropout, generator, noise.get("views"))
        heads = self.heads
        jl = jepa_loss(self.world_model.encode, heads.target_encoder.encode, heads.projector, heads.predictor,
                       heads.target_projector, obs_q, obs_k)
        return self.coef * jl, [jl]

    @torch.no_grad()
    def after_update(self) -> None:
        """``optax.incremental_update(online, target, 1 - jepa_ema)``:
        ``step * online + (1 - step) * target``."""
        torch._foreach_mul_(self.targets, 1.0 - self.step_size)
        torch._foreach_add_(self.targets, torch._foreach_mul(self.online, self.step_size))


def make_train_step(agent: JEPAAgent, optimizers: Dict[str, torch.optim.Optimizer], cfg, is_continuous: bool):
    """DreamerV3's gradient step with the JEPA term (:class:`JEPATerm`);
    ``skip_update`` reverts the heads and both targets with the rest."""
    return make_dreamer_train_step(agent, optimizers, cfg, is_continuous, JEPATerm(agent, cfg))


@register_algorithm()
def main(runtime, cfg) -> Dict[str, Any]:
    """The DreamerV3-JEPA loop: DreamerV3's (``_dreamer_main``) with the
    JEPA agent and step; its checkpoints hold the ``jepa`` tree and the
    world-model optimizer's state over the world model and the heads, as
    the JAX package's do."""
    return _dreamer_main(runtime, cfg, build_agent, make_train_step)
