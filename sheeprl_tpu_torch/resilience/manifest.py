"""Which checkpoint to resume from (counterpart of
``sheeprl_tpu/resilience/manifest.py``, its read side).

The JAX package writes a ``<ckpt>.manifest.json`` sidecar after each
checkpoint has landed: ``{"format": 1, "step": ..., "bytes": N, "sha256":
"...", ...}``.  Resume verifies a checkpoint against it (size, then the
content digest) and, given a directory, takes the newest checkpoint that
verifies.  A checkpoint without a manifest is "legacy": it verifies by
unpickling.  The port does not write manifests yet (the write side waits
with diagnostics, ROADMAP.md Queue 1), so its own checkpoints are legacy
ones; a JAX run's checkpoints verify by their manifests.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

MANIFEST_SUFFIX = ".manifest.json"

_STEP_RE = re.compile(r"ckpt_(\d+)")


def manifest_path(ckpt_path: str) -> str:
    return str(ckpt_path) + MANIFEST_SUFFIX


def checkpoint_step(ckpt_path: str) -> Optional[int]:
    """Policy step of a checkpoint, from its ``ckpt_<step>_<rank>.ckpt``
    name."""
    match = _STEP_RE.search(os.path.basename(str(ckpt_path)))
    return int(match.group(1)) if match else None


def _file_digest(path: str, chunk_bytes: int = 1 << 20) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fp:
        for block in iter(lambda: fp.read(chunk_bytes), b""):
            digest.update(block)
    return digest.hexdigest()


def read_manifest(ckpt_path: str) -> Optional[Dict[str, Any]]:
    """The sidecar, or None when it is absent or unreadable (both mean a
    legacy checkpoint)."""
    path = manifest_path(ckpt_path)
    if not os.path.exists(path):
        return None
    try:
        with open(path, encoding="utf-8") as fp:
            entry = json.load(fp)
    except (OSError, json.JSONDecodeError):
        return None
    return entry if isinstance(entry, dict) else None


def verify_checkpoint(ckpt_path: str, deep: bool = True) -> Tuple[bool, str]:
    """``(ok, reason)`` for one checkpoint file, never raising.  With a
    manifest: its byte size, and with ``deep`` its digest.  Without one
    (legacy): a non-empty file, and with ``deep`` a successful unpickle."""
    ckpt_path = str(ckpt_path)
    if not os.path.isfile(ckpt_path):
        return False, "missing"
    size = os.path.getsize(ckpt_path)
    if size == 0:
        return False, "empty"
    entry = read_manifest(ckpt_path)
    if entry is None:
        if not deep:
            return True, "legacy"
        from sheeprl_tpu_torch.utils.checkpoint import load_state

        try:
            load_state(ckpt_path)
        except Exception as err:  # any failure to unpickle means not resumable
            return False, f"unreadable:{type(err).__name__}"
        return True, "legacy"
    if entry.get("bytes") != size:
        return False, "size_mismatch"
    if deep and entry.get("sha256") != _file_digest(ckpt_path):
        return False, "digest_mismatch"
    return True, "verified"


def _sort_key(path: Path) -> Tuple[int, float]:
    step = checkpoint_step(str(path))
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        mtime = 0.0
    return (step if step is not None else -1, mtime)


def list_checkpoints(root: str) -> List[str]:
    """Every ``*.ckpt`` under ``root`` (a file passes through), newest
    first: by step, the mtime breaking ties."""
    p = Path(root)
    if p.is_file():
        return [str(p)]
    if not p.is_dir():
        return []
    return [str(c) for c in sorted(p.rglob("*.ckpt"), key=_sort_key, reverse=True)]


def newest_verified_checkpoint(root: str, deep: bool = True) -> Tuple[Optional[str], List[Dict[str, str]]]:
    """The newest checkpoint under ``root`` that verifies, and a
    ``{path, reason}`` record of every newer one that did not.  (The JAX
    package also holds a multi-host group to all its shards; the port writes
    one file a checkpoint.)"""
    skipped: List[Dict[str, str]] = []
    for candidate in list_checkpoints(root):
        ok, reason = verify_checkpoint(candidate, deep=deep)
        if ok:
            return candidate, skipped
        skipped.append({"path": candidate, "reason": reason})
    return None, skipped


def resolve_resume_from(spec: str) -> str:
    """``checkpoint.resume_from`` -> a checkpoint file that verifies.  A
    directory (run, ``version_N`` or checkpoint directory) selects the
    newest one that verifies; a file must verify itself."""
    path = Path(str(spec))
    if path.is_dir():
        best, skipped = newest_verified_checkpoint(str(path), deep=True)
        if best is None:
            raise FileNotFoundError(
                f"No verifiable checkpoint under '{spec}' ({len(skipped)} candidate(s) rejected: "
                f"{[s['reason'] for s in skipped[:5]]})"
            )
        return best
    if not path.is_file():
        raise FileNotFoundError(f"Checkpoint '{spec}' does not exist")
    ok, reason = verify_checkpoint(str(path), deep=True)
    if not ok:
        raise ValueError(f"Checkpoint '{spec}' fails verification ({reason}); pass its run directory instead "
                         "to resume from the newest verified checkpoint")
    return str(path)
