"""Checkpoint files: pickled trees of numpy arrays (counterpart of
``sheeprl_tpu/utils/checkpoint.py``: ``save_state``/``load_state`` and the
``CheckpointCallback``).

Both packages write the same format, so the port reads a checkpoint the JAX
package wrote and the other way round.  A JAX training checkpoint also holds
optax optimizer states, pickled as optax classes; the port reads those
without importing optax: every class outside numpy and a few builtins loads
as a :class:`ForeignObject` that keeps its constructor arguments.  That
restriction also keeps an unpickled file from calling arbitrary code.
"""

from __future__ import annotations

import os
import pickle
import re
from pathlib import Path
from typing import Any, Dict, Optional, Set, Tuple

_SAFE_BUILTINS = {("builtins", n) for n in ("set", "frozenset", "complex", "slice", "range", "bytearray")}
_SAFE_BUILTINS.add(("collections", "OrderedDict"))


class ForeignObject(tuple):
    """Stand-in for an object of a class the port does not load (optax
    states, flax containers): a tuple of its constructor arguments plus the
    pickled state, tagged with the original ``module.name``."""

    qualname = ""

    def __new__(cls, *args):
        return super().__new__(cls, args)

    def __setstate__(self, state: Any) -> None:
        self.__dict__["state"] = state

    def __repr__(self) -> str:
        return f"ForeignObject<{self.qualname}>{tuple(self)!r}"


_FOREIGN: Dict[Tuple[str, str], type] = {}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str) -> Any:
        if module == "numpy" or module.startswith("numpy.") or (module, name) in _SAFE_BUILTINS:
            return super().find_class(module, name)
        key = (module, name)
        if key not in _FOREIGN:
            _FOREIGN[key] = type(name, (ForeignObject,), {"qualname": f"{module}.{name}"})
        return _FOREIGN[key]


def npify(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor turned into a host numpy array."""
    if isinstance(tree, dict):
        return {k: npify(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(npify(v) for v in tree)
    if hasattr(tree, "detach") and hasattr(tree, "cpu"):
        tree = tree.detach().cpu()
        # numpy has no bfloat16: stored as float32, which holds it exactly
        return (tree.float() if str(tree.dtype) == "torch.bfloat16" else tree).numpy()
    return tree


def save_state(path: str, state: Dict[str, Any]) -> None:
    """Atomic tmp+rename checkpoint write, fsync'd before the rename."""
    path = str(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fp:
        pickle.dump(npify(state), fp, protocol=pickle.HIGHEST_PROTOCOL)
        fp.flush()
        os.fsync(fp.fileno())
    os.replace(tmp, path)


def load_state(path: str) -> Dict[str, Any]:
    with open(path, "rb") as fp:
        state = _Unpickler(fp).load()
    if not isinstance(state, dict):
        raise ValueError(f"Checkpoint '{path}' holds a {type(state).__name__}, expected a dict")
    return state


_STEP_RE = re.compile(r"ckpt_(\d+)_\d+\.ckpt$")

#: checkpoints ``keep_last`` never deletes: the one the run resumed from
#: (``cli.resume_from_checkpoint`` registers it), so that a crash before the
#: first new save still has it to fall back to
PROTECTED_CHECKPOINTS: Set[str] = set()


def protect_checkpoint(path: str) -> None:
    PROTECTED_CHECKPOINTS.add(os.path.abspath(str(path)))


class CheckpointCallback:
    """The checkpoint hook (``runtime.call("on_checkpoint_coupled", ...)``).
    With a replay buffer, its state is saved with the last stored step of
    every env marked truncated, so that an episode in flight does not
    bootstrap across the checkpoint: the host buffer is marked and unmarked
    around the save, the device ring's host snapshot is marked (the ring on
    the card stays as it is).  ``keep_last`` keeps that many newest
    checkpoints of the directory, and never the protected ones."""

    def __init__(self, keep_last: Optional[int] = None, export: bool = False):
        if export:
            raise NotImplementedError("buffer.export=True (dataset export) is not ported yet: see ROADMAP.md Queue 1")
        self.keep_last = keep_last

    def on_checkpoint_coupled(self, runtime, ckpt_path: str, state: Dict[str, Any], replay_buffer: Any = None) -> None:
        from sheeprl_tpu_torch.data.device_buffer import DeviceSequentialReplayBuffer

        saved = []
        if isinstance(replay_buffer, DeviceSequentialReplayBuffer):
            rb_state = replay_buffer.state_dict()
            truncated = rb_state["buffer"].get("truncated")
            if truncated is not None:
                for e in range(replay_buffer.n_envs):
                    if rb_state["filled"][e] > 0:
                        truncated[(rb_state["pos"][e] - 1) % replay_buffer.buffer_size, e] = 1
            state = {**state, "rb": rb_state}
        elif replay_buffer is not None:
            for b in replay_buffer.buffer:
                if "truncated" in b.buffer:
                    last = (b._pos - 1) % b.buffer_size
                    saved.append((b, last, b.buffer["truncated"][last].copy()))
                    b.buffer["truncated"][last] = 1
            state = {**state, "rb": replay_buffer.state_dict()}
        try:
            runtime.save(ckpt_path, state)
        finally:
            for b, last, value in saved:
                b.buffer["truncated"][last] = value
        if self.keep_last:
            self._delete_old_checkpoints(Path(ckpt_path).parent)

    def _delete_old_checkpoints(self, ckpt_folder: Path) -> None:
        ckpts = [p for p in ckpt_folder.glob("ckpt_*.ckpt") if _STEP_RE.search(p.name)]
        ckpts.sort(key=lambda p: int(_STEP_RE.search(p.name).group(1)))
        for old in ckpts[: max(0, len(ckpts) - int(self.keep_last))]:
            if os.path.abspath(old) not in PROTECTED_CHECKPOINTS:
                old.unlink()
