"""Offline RL (counterpart of ``sheeprl_tpu/offline``), on top of
:mod:`sheeprl_tpu_torch.data.datasets`:

* :mod:`~sheeprl_tpu_torch.offline.export` turns replay experience into
  durable sharded datasets: the checkpoint hook behind ``buffer.export=True``
  (serialization on the resilience async writer's thread), the run-dir
  converter (``python -m sheeprl_tpu_torch export <run dir>``) and
  ``export_buffer``;
* :mod:`~sheeprl_tpu_torch.offline.train` is the env-free training mode
  behind ``algo.offline.enabled=true``: ``cli.run`` builds no env or player
  and drives the algorithms' own train steps (SAC and DroQ on flat batches
  with an optional conservative Q penalty, DreamerV3 on sequence windows)
  from the streaming loader, under the diagnostics.
"""

from sheeprl_tpu_torch.offline.export import BufferDatasetExporter, export_buffer, export_run_dir

__all__ = ["BufferDatasetExporter", "export_buffer", "export_run_dir"]
