"""Tracer interface the serving tier takes (counterpart of
``sheeprl_tpu/diagnostics/tracing.py::NullTracer``).  The port has no span
writer yet, so the batcher runs with the no-op tracer."""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Optional


class NullTracer:
    """No-op tracer."""

    path: Optional[str] = None

    @contextmanager
    def span(self, name: str, **args: Any):
        yield

    def now_us(self) -> int:
        return 0

    def emit_complete(self, name: str, ts_us: int, dur_us: int, **args: Any) -> None:
        pass

    def instant(self, name: str, **args: Any) -> None:
        pass

    def close(self) -> None:
        pass
