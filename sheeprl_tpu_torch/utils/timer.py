"""Wall-clock timers (counterpart of ``sheeprl_tpu/utils/timer.py``).

A ``ContextDecorator`` with a class-level registry of named
:class:`~sheeprl_tpu_torch.utils.metric.SumMetric`s: the training loops time
their two phases (``Time/env_interaction_time``, ``Time/train_time``) and
derive the ``Time/sps_*`` metrics from them.  ``timer.disabled`` is the
switch of ``metric.disable_timer`` and ``metric.log_level=0``.

PyTorch launches device work asynchronously, so a block that only queues
kernels would time its launches.  ``timer(name, device)`` with a CUDA device
records a CUDA event on the device's current stream at the start and at the
end of the block instead of reading the host clock: the time between the two
events holds the device work the block queued, and no call waits on the
card.  :meth:`timer.compute` reads those pairs, at log time, where the loops
wait on the card anyway.  Disabled, a timer reads no clock and records no
event.
"""

from __future__ import annotations

import time
from contextlib import ContextDecorator
from typing import Any, Dict, List, Tuple

from sheeprl_tpu_torch.utils.metric import SumMetric


class timer(ContextDecorator):
    disabled: bool = False
    timers: Dict[str, SumMetric] = {}
    # per name, the (start, end) CUDA events of blocks not yet summed
    _events: Dict[str, List[Tuple[Any, Any]]] = {}

    def __init__(self, name: str, device: Any = None):
        self.name = name
        self._device = device if getattr(device, "type", None) == "cuda" else None
        if not timer.disabled and name not in timer.timers:
            timer.timers[name] = SumMetric()

    def _event(self):
        import torch

        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self._device))
        return event

    def __enter__(self) -> "timer":
        if not timer.disabled:
            self._start = self._event() if self._device is not None else time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if not timer.disabled:
            if self._device is not None:
                timer._events.setdefault(self.name, []).append((self._start, self._event()))
            else:
                timer.timers[self.name].update(time.perf_counter() - self._start)
        return False

    @classmethod
    def compute(cls) -> Dict[str, float]:
        for name, pairs in cls._events.items():
            for start, end in pairs:
                end.synchronize()
                cls.timers[name].update(start.elapsed_time(end) / 1e3)
            pairs.clear()
        return {name: m.compute() for name, m in cls.timers.items()}

    @classmethod
    def reset(cls) -> None:
        cls._events.clear()
        for m in cls.timers.values():
            m.reset()
