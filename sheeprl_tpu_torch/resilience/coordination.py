"""Checkpoint groups (counterpart of ``sheeprl_tpu/resilience/coordination.py``).

A checkpoint written as a group is one ``ckpt_<step>_<rank>.ckpt`` file a
rank, each with a manifest sidecar whose ``group`` record is ``{"world_size",
"rank", "group_step"}``.  The port writes groups over processes
(:func:`coordinated_save`, the multi-process ``Runtime.save``: each
process's file holds its own state, replay included) and for FSDP's
partial-shard checkpoints (``resilience/sharded.py``: "rank" is the
model-axis shard index of the one process), and reads the JAX package's.
Resume selection (``resilience/manifest.py``) takes a step only when every
rank's file verifies with the same ``group_step``, and only its rank-0
file (a non-zero rank then reads its own, ``Runtime.load``); a torn group
is skipped with ``reason=incomplete_group``."""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

from sheeprl_tpu_torch.resilience.manifest import (checkpoint_step, read_manifest, save_verified_checkpoint,
                                                   verify_checkpoint)

_RANK_RE = re.compile(r"^(?P<stem>.*ckpt_\d+)_(?P<rank>\d+)\.ckpt$")
_FALLBACK_RANK_RE = re.compile(r"^(?P<stem>.*)\.rank\d+(?P<ext>\.[^.]+)$")


def rank_shard_path(ckpt_path: str, rank: int) -> str:
    """``.../ckpt_<step>_0.ckpt`` -> ``.../ckpt_<step>_<rank>.ckpt``; a path
    without the rank suffix gains ``.rank<r>`` before its extension.  Both
    spellings map a shard of another rank to ``rank`` (``last.rank0.ckpt``
    to ``last.rank1.ckpt``, never ``last.rank0.rank1.ckpt``)."""
    ckpt_path = str(ckpt_path)
    match = _RANK_RE.match(ckpt_path)
    if match:
        return f"{match.group('stem')}_{int(rank)}.ckpt"
    match = _FALLBACK_RANK_RE.match(ckpt_path)
    if match:
        return f"{match.group('stem')}.rank{int(rank)}{match.group('ext')}"
    root, ext = os.path.splitext(ckpt_path)
    return f"{root}.rank{int(rank)}{ext}"


def group_record(world_size: int, rank: int, group_step: Optional[int]) -> Dict[str, Any]:
    return {"world_size": int(world_size), "rank": int(rank), "group_step": group_step}


def group_status(ckpt_path: str, deep: bool = True, assume_verified: Tuple[int, ...] = ()) -> Tuple[bool, str]:
    """``(complete, reason)`` of the group a checkpoint belongs to: one
    without a group record is complete (``ungrouped``); a grouped one only
    when every rank's file exists, verifies and records the same
    ``group_step`` (``group_verified``), else ``incomplete_group``.  The
    ranks in ``assume_verified`` were verified by the caller: their
    manifests are still read, their files not hashed again."""
    entry = read_manifest(ckpt_path)
    group = (entry or {}).get("group")
    if not isinstance(group, Mapping):
        return True, "ungrouped"
    world = int(group.get("world_size", 1) or 1)
    if world <= 1:
        return True, "ungrouped"
    step = group.get("group_step")
    for rank in range(world):
        shard = rank_shard_path(ckpt_path, rank)
        if rank not in assume_verified and not verify_checkpoint(shard, deep=deep)[0]:
            return False, "incomplete_group"
        sib_group = (read_manifest(shard) or {}).get("group")
        if not isinstance(sib_group, Mapping) or sib_group.get("group_step") != step:
            return False, "incomplete_group"
    return True, "group_verified"


def shard_rank(ckpt_path: str) -> Optional[int]:
    """The rank a checkpoint's manifest group records, or None for an
    ungrouped checkpoint (resume selection returns only a group's rank 0)."""
    group = (read_manifest(ckpt_path) or {}).get("group")
    if not isinstance(group, Mapping) or int(group.get("world_size", 1) or 1) <= 1:
        return None
    try:
        return int(group.get("rank", 0))
    except (TypeError, ValueError):
        return 0



def coordinated_save(runtime, path: str, state: Mapping[str, Any]) -> None:
    """The multi-process ``Runtime.save``: an entry barrier (no file is
    written while another rank still trains), the step agreed by broadcast
    from rank 0, every rank's ``ckpt_<step>_<rank>.ckpt`` with its group
    manifest, an exit barrier.  Rank 0 writes through the diagnostics'
    resilience layer when it is open (async writer, ``ckpt_begin`` /
    ``ckpt_end`` journaled), the others blocking: they wait at the exit
    barrier anyway, and a blocking write is its own proof for the group's
    completeness check."""
    world, rank = int(runtime.process_count), int(runtime.global_rank)
    runtime.barrier()
    step = runtime.broadcast(checkpoint_step(path, state), src=0)
    group = group_record(world, rank, step)
    shard = rank_shard_path(path, rank)
    diagnostics = getattr(runtime, "diagnostics", None)
    routed = rank == 0 and diagnostics is not None and diagnostics.save_checkpoint(shard, state, group=group)
    if not routed:
        save_verified_checkpoint(shard, state, step=step, group=group)
    runtime.barrier()
