"""Host-side config containers (counterpart of ``sheeprl_tpu/utils/utils.py``)."""

from __future__ import annotations

from typing import Any, Dict, Mapping


class dotdict(dict):
    """A dictionary supporting dot notation."""

    __getattr__ = dict.get
    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in self.items():
            if isinstance(v, dict) and not isinstance(v, dotdict):
                self[k] = dotdict(v)

    def __getstate__(self):
        return dict(self)

    def __setstate__(self, state):
        self.update(state)

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.items():
            out[k] = v.as_dict() if isinstance(v, dotdict) else v
        return out


def nest_dotted(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Turn ``{"a.b": 1}`` into ``{"a": {"b": 1}}``."""
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        node = out
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out
