"""DreamerV3-JEPA helpers (counterpart of
``sheeprl_tpu/algos/dreamer_v3_jepa/utils.py``): the metric keys."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.dreamer_v3.utils import AGGREGATOR_KEYS as DV3_AGGREGATOR_KEYS

AGGREGATOR_KEYS = DV3_AGGREGATOR_KEYS | {"Loss/jepa_loss"}
MODELS_TO_REGISTER = {"world_model", "actor", "critic", "target_critic", "moments"}
