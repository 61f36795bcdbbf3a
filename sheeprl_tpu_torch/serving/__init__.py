"""Policy-as-a-service: a batched, hot-reloading, stateful multi-model
inference tier for checkpointed agents (counterpart of
``sheeprl_tpu/serving``).

* :mod:`~sheeprl_tpu_torch.serving.loader` — checkpoint discovery, the
  per-algorithm policy adapters (``dreamer_v3``, ``ppo``, ``a2c``, ``sac``,
  ``ppo_recurrent``), ``load_params`` for a hot swap, and the health gate
  that reads the training run's journal before a checkpoint may be promoted;
* :mod:`~sheeprl_tpu_torch.serving.batcher` — the dynamic request batcher:
  requests wait up to ``serving.max_delay_ms``, are padded to the nearest
  bucket width and dispatched as one device step; beyond
  ``serving.max_queue`` load is shed with 503 + ``Retry-After``;
* :mod:`~sheeprl_tpu_torch.serving.sessions` — device-resident recurrent
  state for stateful policies, keyed by client session id, LRU-evicted
  (journaled ``session_evict``);
* :mod:`~sheeprl_tpu_torch.serving.registry` — N resident models on one
  server, ``/act`` routing on the request's ``model`` field, per-model
  ``{model="..."}`` metric series;
* :mod:`~sheeprl_tpu_torch.serving.request_log` — dispatched ``/act``
  traffic appended to per-model offline dataset shards (the
  ``data/datasets.py`` format, journaled ``request_log_rotate``);
* :mod:`~sheeprl_tpu_torch.serving.server` — :class:`PolicyService` (the
  per-bucket steps, the atomic swap of the served modules, journaled
  ``ckpt_promote`` / ``ckpt_reject``), the SLO monitor and phase histograms,
  the HTTP tier (``POST /act``, ``GET /metrics``, ``GET /healthz``) and the
  checkpoint watcher.

Entry point: ``python -m sheeprl_tpu_torch serve checkpoint_path=...``.
"""

from __future__ import annotations

from sheeprl_tpu_torch.serving.batcher import DynamicBatcher, ServeError, pick_bucket
from sheeprl_tpu_torch.serving.loader import (
    PolicyHandle,
    agent_state_from_checkpoint,
    build_policy,
    checkpoint_health,
    checkpoint_step,
    latest_checkpoint,
    load_policy,
)
from sheeprl_tpu_torch.serving.registry import ModelEntry, ModelRegistry, render_registry_metrics
from sheeprl_tpu_torch.serving.request_log import RequestLog
from sheeprl_tpu_torch.serving.server import PolicyService, ServeApp, serve_checkpoint
from sheeprl_tpu_torch.serving.sessions import SessionStore, make_slab_step

__all__ = [
    "DynamicBatcher",
    "ModelEntry",
    "ModelRegistry",
    "PolicyHandle",
    "PolicyService",
    "RequestLog",
    "ServeApp",
    "ServeError",
    "SessionStore",
    "agent_state_from_checkpoint",
    "build_policy",
    "checkpoint_health",
    "checkpoint_step",
    "latest_checkpoint",
    "load_policy",
    "make_slab_step",
    "pick_bucket",
    "render_registry_metrics",
    "serve_checkpoint",
]
