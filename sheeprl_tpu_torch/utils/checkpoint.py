"""Checkpoint files: pickled trees of numpy arrays (counterpart of
``sheeprl_tpu/utils/checkpoint.py``: ``save_state``/``load_state`` and the
``CheckpointCallback``).

Both packages write the same format, so the port reads a checkpoint the JAX
package wrote and the other way round.  A JAX training checkpoint also holds
optax optimizer states, pickled as optax classes; the port reads those
without importing optax: every class outside numpy and a few builtins loads
as a :class:`ForeignObject` that keeps its constructor arguments.  That
restriction also keeps an unpickled file from calling arbitrary code.

The port writes each optimizer's state as the tree the JAX package pickles
for optax's ``chain(clip_by_global_norm, adam)``, without optax: each optax
state is an :class:`OptaxState`, pickled by reference to the optax class it
stands for (``optax._src.transform.ScaleByAdamState`` ...) by a pickler that
writes the reference without importing it (:class:`_Pickler`), so the JAX
package resumes a port checkpoint, and the port reads it back through the
same ``ForeignObject`` path as a JAX one.  ``save_state(..., digest=True)``
hashes the pickle with sha256 as it streams out, for the manifest sidecar
(``resilience/manifest.py``).
"""

from __future__ import annotations

import copyreg
import hashlib
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

    def __reduce__(self):
        # pickled back as the class it stands for (:class:`_Pickler`), so a
        # tree read from a checkpoint is written again as it was
        state = self.__dict__.get("state")
        return (copyreg.__newobj__, (type(self), *self)) + (() if state is None else (state,))

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
        items = [npify(v) for v in tree]
        # a NamedTuple, or the stand-in of one read from a checkpoint, keeps its class
        return type(tree)(*items) if hasattr(tree, "_fields") or isinstance(tree, ForeignObject) else type(tree)(items)
    if hasattr(tree, "detach") and hasattr(tree, "cpu"):
        tree = tree.detach().cpu()
        # numpy has no bfloat16: stored as float32, which holds it exactly
        return (tree.float() if str(tree.dtype) == "torch.bfloat16" else tree).numpy()
    return tree


class OptaxState:
    """Stand-in for an optax state namedtuple (``module.name`` and its
    field values), pickled as that class: ``make(module, name)`` gives the
    stand-in class, whose instances pickle by reference to the optax class."""

    pickle_as: Tuple[str, str] = ("", "")

    def __init__(self, *fields: Any):
        self.fields = tuple(fields)

    def __reduce__(self):
        return copyreg.__newobj__, (type(self), *self.fields)

    def __repr__(self) -> str:
        return f"{'.'.join(self.pickle_as)}{self.fields!r}"

    @staticmethod
    def make(module: str, name: str) -> type:
        key = (module, name)
        if key not in _OPTAX_CLASSES:
            _OPTAX_CLASSES[key] = type(name, (OptaxState,), {"pickle_as": key})
        return _OPTAX_CLASSES[key]


_OPTAX_CLASSES: Dict[Tuple[str, str], type] = {}


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, writing an :class:`OptaxState` class (or a
    :class:`ForeignObject` one) as a global reference to the class it stands
    for.  The C pickler imports every class it writes by reference to check
    it, and the port has no optax."""

    def save_global(self, obj: Any, name: Optional[str] = None) -> None:
        ref = None
        if isinstance(obj, type) and issubclass(obj, OptaxState):
            ref = obj.pickle_as
        elif isinstance(obj, type) and issubclass(obj, ForeignObject) and obj.qualname:
            ref = tuple(obj.qualname.rsplit(".", 1))
        if ref is None:
            super().save_global(obj, name)
            return
        self.save(ref[0])
        self.save(ref[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _HashingWriter:
    """File-object shim that sha256-digests the bytes as the pickle streams
    out, so the manifest never re-reads the checkpoint."""

    def __init__(self, fp):
        self._fp = fp
        self.sha = hashlib.sha256()
        self.nbytes = 0

    def write(self, data) -> int:
        # protocol 5 hands PickleBuffers to write(); a memoryview covers
        # anything bytes-like
        view = memoryview(data)
        self.sha.update(view)
        self.nbytes += view.nbytes
        return self._fp.write(data)


def save_state(path: str, state: Dict[str, Any], digest: bool = False) -> Optional[Dict[str, Any]]:
    """Atomic tmp+rename checkpoint write, fsync'd before the rename.  With
    ``digest`` returns ``{"sha256", "bytes"}`` of the file, computed while
    streaming."""
    path = str(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fp:
        sink = _HashingWriter(fp) if digest else fp
        _Pickler(sink, protocol=pickle.HIGHEST_PROTOCOL).dump(npify(state))
        fp.flush()
        os.fsync(fp.fileno())
    os.replace(tmp, path)
    if digest:
        return {"sha256": sink.sha.hexdigest(), "bytes": sink.nbytes}
    return None


def load_state(path: str) -> Dict[str, Any]:
    with open(path, "rb") as fp:
        state = _Unpickler(fp).load()
    if not isinstance(state, dict):
        raise ValueError(f"Checkpoint '{path}' holds a {type(state).__name__}, expected a dict")
    return state


_STEP_RE = re.compile(r"ckpt_(\d+)_\d+\.ckpt$")
#: ``*.ckpt.tmp`` leftovers older than this are reaped when ``keep_last``
#: prunes (younger ones may be the async writer's)
TMP_ORPHAN_AGE_S = 900.0

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
    checkpoints of the directory, and never the protected ones.  With
    ``export`` (``buffer.export``) each save with a replay buffer is
    followed by the incremental export of its rows into ``<run dir>/dataset``
    (``offline/export.py::checkpoint_export``): the live rows, unmarked."""

    def __init__(self, keep_last: Optional[int] = None, export: bool = False):
        self.keep_last = keep_last
        self.export = bool(export)

    def on_checkpoint_coupled(self, runtime, ckpt_path: str, state: Dict[str, Any], replay_buffer: Any = None) -> None:
        from sheeprl_tpu_torch.data.buffers import EpisodeBuffer, ReplayBuffer
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
        elif isinstance(replay_buffer, EpisodeBuffer):
            # stored whole; the open episodes go as they are, as in JAX
            state = {**state, "rb": replay_buffer.state_dict()}
        elif replay_buffer is not None:
            # the last row written is marked truncated in the snapshot, then
            # restored: a resumed run does not continue that episode
            subs = [replay_buffer] if isinstance(replay_buffer, ReplayBuffer) else replay_buffer.buffer
            for b in subs:
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
        # rank 0 exports and prunes for the group: the ranks' groups share
        # the directory
        rank_zero = getattr(runtime, "is_global_zero", True)
        if self.export and replay_buffer is not None and rank_zero:
            from sheeprl_tpu_torch.offline.export import checkpoint_export

            checkpoint_export(self, runtime, ckpt_path, replay_buffer)
        if self.keep_last and rank_zero:
            self._delete_old_checkpoints(Path(ckpt_path).parent)

    #: the decoupled loops' player saves, as the JAX callback names them
    on_checkpoint_player = on_checkpoint_coupled

    def _delete_old_checkpoints(self, ckpt_folder: Path) -> None:
        """``keep_last`` pruning by checkpoint group (the files that share a
        step: one, or an FSDP partial-shard group's k), as the JAX callback
        prunes: a group lives and dies whole; the protected checkpoint's
        group survives; when no kept group verifies (shallow), the newest
        older group that does is spared, so resume keeps a target; a
        deleted file takes its manifest with it."""
        from sheeprl_tpu_torch.resilience.manifest import MANIFEST_SUFFIX, reap_orphan_tmps, verify_checkpoint

        # interrupted writes' leftovers, old enough not to be the async
        # writer's own
        reap_orphan_tmps(str(ckpt_folder), max_age_s=TMP_ORPHAN_AGE_S)
        groups: Dict[int, list] = {}
        for p in ckpt_folder.glob("ckpt_*.ckpt"):
            match = _STEP_RE.search(p.name)
            if match:
                groups.setdefault(int(match.group(1)), []).append(p)
        ordered = sorted(groups)
        keep = int(self.keep_last)
        keepers, doomed = ordered[-keep:], ordered[:-keep]
        if not doomed:
            return

        def group_verifies(step: int) -> bool:
            return all(verify_checkpoint(str(p), deep=False)[0] for p in groups[step])

        spared = set()
        if not any(group_verifies(step) for step in keepers):
            spared = {next((step for step in reversed(doomed) if group_verifies(step)), None)}
        for step in doomed:
            if step in spared or any(os.path.abspath(p) in PROTECTED_CHECKPOINTS for p in groups[step]):
                continue
            for old in groups[step]:
                old.unlink(missing_ok=True)
                Path(str(old) + MANIFEST_SUFFIX).unlink(missing_ok=True)
