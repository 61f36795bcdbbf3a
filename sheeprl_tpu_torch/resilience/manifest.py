"""Manifest-verified checkpoints (counterpart of
``sheeprl_tpu/resilience/manifest.py``).

Every checkpoint the port saves gets a ``<ckpt>.manifest.json`` sidecar
after the checkpoint itself has landed, with or without diagnostics
(:func:`save_verified_checkpoint`): ``{"format": 1, "step": ..., "bytes":
N, "sha256": "...", "tree": {path: [shape, dtype]}, "fingerprint": "<the
port's version@git HEAD>", "written_t": ...}``, the JAX package's format, so
its ``verify_checkpoint`` calls a port checkpoint ``verified``.  Resume
verifies a checkpoint against it (size, then the content digest) and, given
a directory, takes the newest checkpoint that verifies.  A checkpoint
without a manifest (an older port run's) is "legacy": it verifies by
unpickling.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

MANIFEST_SUFFIX = ".manifest.json"
MANIFEST_FORMAT = 1

_STEP_RE = re.compile(r"ckpt_(\d+)")


def manifest_path(ckpt_path: str) -> str:
    return str(ckpt_path) + MANIFEST_SUFFIX


def checkpoint_step(ckpt_path: str, state: Optional[Mapping[str, Any]] = None) -> Optional[int]:
    """Policy step of a checkpoint: its ``ckpt_<step>_<rank>.ckpt`` name
    first, the state's counters second."""
    match = _STEP_RE.search(os.path.basename(str(ckpt_path)))
    if match:
        return int(match.group(1))
    if state is not None:
        for key in ("policy_step", "update", "iter_num"):
            value = state.get(key)
            if isinstance(value, (int, float)):
                return int(value)
    return None


def _file_digest(path: str, chunk_bytes: int = 1 << 20) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fp:
        for block in iter(lambda: fp.read(chunk_bytes), b""):
            digest.update(block)
    return digest.hexdigest()


def tree_spec(state: Mapping[str, Any]) -> Dict[str, List[Any]]:
    """``{dotted-path: [shape, dtype]}`` for every array of the state, the
    manifest's record of its structure (optax stand-ins walk by their
    fields, as the JAX package walks the namedtuples)."""
    from sheeprl_tpu_torch.utils.checkpoint import OptaxState

    out: Dict[str, List[Any]] = {}

    def walk(node: Any, prefix: str) -> None:
        if isinstance(node, Mapping):
            for key, value in node.items():
                walk(value, f"{prefix}.{key}" if prefix else str(key))
            return
        if isinstance(node, OptaxState):
            node = node.fields
        if isinstance(node, (list, tuple)):
            for i, value in enumerate(node):
                walk(value, f"{prefix}[{i}]")
            return
        shape = getattr(node, "shape", None)
        dtype = getattr(node, "dtype", None)
        if shape is not None and dtype is not None:
            out[prefix] = [list(shape), str(dtype).replace("torch.", "")]

    walk(state, "")
    return out


def code_fingerprint() -> str:
    """The port's version and, in a git checkout, its HEAD revision (read
    from ``.git``; no subprocess): informational, since resuming across
    revisions is legitimate."""
    import sheeprl_tpu_torch

    version = str(getattr(sheeprl_tpu_torch, "__version__", "?"))
    root = Path(sheeprl_tpu_torch.__file__).resolve().parents[1]
    head_path = root / ".git" / "HEAD"
    rev = ""
    try:
        head = head_path.read_text().strip() if head_path.is_file() else ""
        if head.startswith("ref:"):
            ref_path = root / ".git" / head.split(" ", 1)[1]
            if ref_path.is_file():
                rev = ref_path.read_text().strip()[:12]
        else:
            rev = head[:12]
    except OSError:
        rev = ""
    return f"sheeprl_tpu_torch-{version}@{rev}" if rev else f"sheeprl_tpu_torch-{version}"


def write_manifest(ckpt_path: str, state: Optional[Mapping[str, Any]] = None, step: Optional[int] = None,
                   digest: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """Write the sidecar of an already-landed checkpoint (atomic
    tmp+rename: a crash leaves a checkpoint without a manifest, never a
    manifest of a half-written file).  ``digest`` is ``save_state``'s
    ``{"sha256", "bytes"}``; without it the file is re-read."""
    ckpt_path = str(ckpt_path)
    entry: Dict[str, Any] = {
        "format": MANIFEST_FORMAT,
        "step": step if step is not None else checkpoint_step(ckpt_path, state),
        "bytes": digest["bytes"] if digest else os.path.getsize(ckpt_path),
        "sha256": digest["sha256"] if digest else _file_digest(ckpt_path),
        "fingerprint": code_fingerprint(),
        "written_t": round(time.time(), 3),
    }
    if state is not None:
        entry["tree"] = tree_spec(state)
    out_path = manifest_path(ckpt_path)
    tmp = out_path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fp:
        json.dump(entry, fp)
        fp.flush()
        os.fsync(fp.fileno())
    os.replace(tmp, out_path)
    return entry


def save_verified_checkpoint(path: str, state: Mapping[str, Any], step: Optional[int] = None) -> Dict[str, Any]:
    """Atomic checkpoint save and its manifest; returns ``{path, step,
    bytes, write_ms}`` (a ``ckpt_end`` event's payload).  The digest is
    taken while the pickle streams out."""
    from sheeprl_tpu_torch.utils.checkpoint import save_state

    t0 = time.perf_counter()
    digest = save_state(path, state, digest=True)
    entry = write_manifest(path, state=state, step=step, digest=digest)
    return {"path": str(path), "step": entry["step"], "bytes": entry["bytes"],
            "write_ms": round((time.perf_counter() - t0) * 1e3, 3)}


def reap_orphan_tmps(root: str, max_age_s: float = 0.0) -> List[str]:
    """Delete the ``*.ckpt.tmp`` and manifest ``.tmp`` leftovers of
    interrupted writes under ``root`` older than ``max_age_s`` (a younger
    one may be a write in flight)."""
    p = Path(root)
    if not p.is_dir():
        return []
    now = time.time()
    reaped: List[str] = []
    for pattern in ("*.ckpt.tmp", f"*{MANIFEST_SUFFIX}.tmp"):
        for tmp in p.rglob(pattern):
            try:
                if now - os.path.getmtime(tmp) < max_age_s:
                    continue
                tmp.unlink()
                reaped.append(str(tmp))
            except OSError:  # a racing writer or reaper
                continue
    return reaped


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
