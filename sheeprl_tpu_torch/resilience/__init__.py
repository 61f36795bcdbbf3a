"""Checkpoint verification and resume selection (counterpart of
``sheeprl_tpu/resilience/``; the read side of ``manifest.py`` is ported)."""
