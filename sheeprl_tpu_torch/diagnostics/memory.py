"""Memory and data-movement telemetry (counterpart of
``sheeprl_tpu/diagnostics/memory.py``).

* **Device-memory gauges**: ``torch.cuda.memory_stats`` (bytes allocated,
  their peak, bytes reserved) and ``torch.cuda.mem_get_info`` sampled once
  per metric interval as ``Telemetry/hbm_*``, plus the process RSS as
  ``Telemetry/host_rss_bytes`` and the replay buffer's footprint.  On the
  CPU there is no device source: no ``hbm`` gauge is written and the source
  is journaled as ``none``; host bytes are never reported as device memory.
  A one-shot ``memory_breakdown`` event records the static footprint (the
  parameters, optimizer state and Moments the loop registers, the replay
  buffer) at the first train dispatch.
* **Sync guard**: ``diagnostics.transfers`` = ``off | log | disallow`` wraps
  every instrumented dispatch in ``torch.cuda.set_sync_debug_mode``
  (``warn`` / ``error``), restored after it, since the mode is
  process-global.  ``log`` counts the synchronizing calls inside the step
  (journaled as ``host_transfer`` with the count whenever it changes; the
  CUDA-graph question needs it at zero); ``disallow`` makes one raise,
  journaled as ``host_transfer`` before it propagates.  On the CPU there is
  no sync to count and the guard does nothing.
  ``diagnostics.memory.inject_transfer_iter`` forces one device->host copy
  inside the guarded scope to drill it.
* **OOM forensics**: a ``torch.cuda.OutOfMemoryError`` escaping a dispatch is
  journaled as ``oom`` with a memory snapshot, fsync'd, then re-raised;
  ``diagnostics.memory.inject_oom_iter`` raises one to drill it.

* **Sharding audit**: at the first train dispatch a ``sharding_audit``
  event tables, largest per-shard cost first, every leaf of the replicated
  trees the loop registers (``register_shards``: each shard's replica of the
  parameters, optimizer state, Moments) with its bytes and placement, and
  the dispatch's batch blocks with their devices; replicated leaves of at
  least ``diagnostics.memory.replicated_warn_bytes`` are flagged when the
  data axis has more than one shard.  Under FSDP (armed by the facade's
  ``on_fsdp_shard_map``: ``note_fsdp``) a model shard's slices (the
  parameters its modules hold between steps, the optimizer state) count at
  their own bytes, leaves under the floor are exempt, and what stays
  replicated is flagged; ``Telemetry/fsdp_axis_size`` and
  ``Telemetry/params_bytes_per_device`` (the parameter bytes a shard holds:
  the rule's) join the interval's gauges.  The summary carries its digest.  The
  JAX package's donation audit has no eager counterpart (no buffer is
  donated): ``memory_breakdown`` and ``memory_summary`` say it did not run.
"""

from __future__ import annotations

import os
import threading
import warnings
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import torch

from sheeprl_tpu_torch.diagnostics.schema import MEMORY_EVENTS  # noqa: F401  (the JAX module's import surface)

_TRANSFER_MODES = ("off", "log", "disallow")
_SYNC_MODES = {"log": "warn", "disallow": "error"}
#: what the breakdown and summary say of the audits that did not run
DONATION_NOT_RUN = "not run: eager PyTorch donates no buffers"
SHARDING_NOT_RUN = "not run: the loop registered no shards (its family runs on one device)"
#: the JAX package's default for diagnostics.memory.replicated_warn_bytes
DEFAULT_REPLICATED_WARN_BYTES = 16 * 1024 * 1024
_SYNC_TEXT = "called a synchronizing CUDA operation"


def normalize_transfer_mode(value: Any) -> str:
    """``diagnostics.transfers`` arrives as a string from the CLI but YAML
    1.1 resolves bare ``off``/``on`` to booleans: accept both spellings."""
    if value is None or value is False:
        return "off"
    if value is True:
        return "log"
    mode = str(value).strip().lower()
    if mode in ("", "none", "null", "0", "false"):
        return "off"
    if mode not in _TRANSFER_MODES:
        raise ValueError(f"diagnostics.transfers must be one of {_TRANSFER_MODES}, got {value!r}")
    return mode


# ---------------------------------------------------------------------------
# byte accounting primitives


def _leaves(tree: Any) -> Iterator[Any]:
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _leaf_nbytes(leaf: Any) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    if isinstance(leaf, torch.nn.Module):
        return sum(_leaf_nbytes(t) for t in list(leaf.parameters()) + list(leaf.buffers()))
    if isinstance(leaf, torch.optim.Optimizer):
        return tree_bytes(list(leaf.state.values()))
    nbytes = getattr(leaf, "nbytes", None)
    return int(nbytes) if isinstance(nbytes, (int, float)) else 0


def tree_bytes(tree: Any) -> int:
    """Total bytes of every tensor or array in a tree; a module counts its
    parameters and buffers, an optimizer its state, other leaves 0."""
    return sum(_leaf_nbytes(leaf) for leaf in _leaves(tree))


def _named_leaves(obj: Any, prefix: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every tensor of a module (parameters and
    buffers), optimizer (state), tensor, or dict / list / tuple of them."""
    if isinstance(obj, torch.nn.Module):
        for name, t in list(obj.named_parameters()) + list(obj.named_buffers()):
            yield f"{prefix}/{name}", t
    elif isinstance(obj, torch.optim.Optimizer):
        for g, group in enumerate(obj.param_groups):
            for i, p in enumerate(group["params"]):
                for key, t in sorted(obj.state.get(p, {}).items()):
                    if isinstance(t, torch.Tensor):
                        yield f"{prefix}/group{g}/{i}/{key}", t
    elif isinstance(obj, torch.Tensor):
        yield prefix, obj
    elif isinstance(obj, Mapping):
        for k, v in obj.items():
            yield from _named_leaves(v, f"{prefix}/{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _named_leaves(v, f"{prefix}/{i}")


def sharding_table(devices: List[Any], replicated: Mapping[str, List[Any]], batch: Any, top_n: int = 20,
                   replicated_warn_bytes: Optional[int] = None, fsdp_axis_size: Optional[int] = None,
                   fsdp_min_shard_bytes: Optional[int] = None) -> Dict[str, Any]:
    """Per-leaf bytes and placement (the ``sharding_audit`` payload, the JAX
    ``sharding_table``'s keys): each leaf of shard 0's replica of every
    ``replicated`` tree, held once per shard (``n_devices`` shards, its full
    size on each), and each tensor of the dispatch's ``batch`` (a shard's
    block, on its device).  Largest per-shard cost first, cut to ``top_n``
    rows; ``flagged_replicated`` names, over every leaf, the replicated ones
    of at least ``replicated_warn_bytes`` when there is more than one
    shard.

    Under FSDP (``fsdp_axis_size > 1``) a tensor that is a model shard's
    slice (a parameter the shard's modules hold cut between steps, its
    optimizer state) counts at its own bytes on each shard, not
    replicated.  The flag then names the replicated leaves of at least
    ``fsdp_min_shard_bytes`` (a smaller leaf is replicated on purpose),
    which the rule cannot cut (no dimension divisible by the axis), with
    the JAX package's hint."""
    from sheeprl_tpu_torch.parallel.fsdp import shard_axis, sliced_state_ids

    n = len(devices)
    where = ", ".join(str(d) for d in devices)
    fsdp_on = fsdp_axis_size is not None and int(fsdp_axis_size) > 1
    sliced = set().union(*(sliced_state_ids(per_shard[0]) for per_shard in replicated.values())) if fsdp_on else set()
    rows: List[Dict[str, Any]] = []
    for name, per_shard in replicated.items():
        for path, t in _named_leaves(per_shard[0], name):
            nbytes = t.numel() * t.element_size()
            if not nbytes:
                continue
            row = {"path": path, "shape": list(t.shape), "dtype": str(t.dtype).replace("torch.", ""),
                   "bytes": nbytes * n, "sharding": f"replicated over the {n} shards: {where}"[:120],
                   "n_devices": n, "replicated": n > 1, "bytes_per_device": nbytes}
            if id(t) in sliced:
                row.update(sharding=f"model shard's slice (1/{int(fsdp_axis_size)}) on each of the {n} shards",
                           replicated=False)
            elif fsdp_on:
                row["rule_axis"] = shard_axis(tuple(t.shape), t.dtype, int(fsdp_axis_size), fsdp_min_shard_bytes)
            rows.append(row)
    for path, t in _named_leaves(batch, "batch"):
        nbytes = t.numel() * t.element_size()
        if nbytes and t.dim() > 0:
            rows.append({"path": path, "shape": list(t.shape), "dtype": str(t.dtype).replace("torch.", ""),
                         "bytes": nbytes, "sharding": f"a shard's block on {t.device}", "n_devices": 1,
                         "replicated": False, "bytes_per_device": nbytes})
    rows.sort(key=lambda r: r["bytes_per_device"], reverse=True)
    out: Dict[str, Any] = {
        "n_shards": n,
        "devices": [str(d) for d in devices],
        "n_leaves": len(rows),
        "total_bytes": sum(r["bytes"] for r in rows),
        "total_bytes_per_device": sum(r["bytes_per_device"] for r in rows),
        "rows": rows[: max(1, int(top_n))],
    }
    if replicated_warn_bytes is not None:
        exempt_below = int(fsdp_min_shard_bytes or 0) if fsdp_on else 0
        flagged = [r for r in rows if r["replicated"]
                   and r["bytes_per_device"] >= max(replicated_warn_bytes, exempt_below)]
        out["flagged_replicated"] = [r["path"] for r in flagged]
        hints = []
        if flagged and not fsdp_on:
            hints.append("large replicated leaves on a multi-device mesh: set distribution.fsdp_axis_size > 1 "
                         "(fabric.fsdp) to shard them over a second 'model' mesh axis (howto/sharding.md)")
        if fsdp_on and any(r.get("rule_axis") is None for r in flagged):
            hints.append(f"replicated leaves >= distribution.fsdp_min_shard_bytes under "
                         f"fsdp_axis_size={int(fsdp_axis_size)}: no dimension is divisible by the model axis "
                         "— consider padding the layer width or lowering the axis size (howto/sharding.md)")
        if hints:
            out["hint"] = "; ".join(hints)
    for r in rows:
        r.pop("rule_axis", None)
    return out


def device_memory_stats(device: Any = None) -> List[Dict[str, Any]]:
    """Per CUDA device of the run, the allocator's counters under the JAX
    package's names (``bytes_in_use``, ``peak_bytes_in_use``) and the
    card's (``bytes_reserved``, ``bytes_free``, ``bytes_limit``); ``[]``
    for a CPU run, whose caller then reports no device memory."""
    if device is None or not str(device).startswith("cuda"):
        return []
    dev = torch.device(device)
    stats = torch.cuda.memory_stats(dev)
    free, total = torch.cuda.mem_get_info(dev)
    return [{
        "device": str(dev.index if dev.index is not None else torch.cuda.current_device()),
        "kind": torch.cuda.get_device_name(dev),
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        "num_alloc_retries": int(stats.get("num_alloc_retries", 0)),
        "num_ooms": int(stats.get("num_ooms", 0)),
        "bytes_free": int(free),
        "bytes_limit": int(total),
    }]


def host_rss_bytes() -> Optional[int]:
    """Resident set size of this process (Linux ``/proc/self/statm``), or
    None where unreadable; replay buffers in host RAM show up here."""
    try:
        with open("/proc/self/statm") as fp:
            pages = int(fp.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


def buffer_footprint(buffer: Any) -> Dict[str, int]:
    """Host/disk/device byte footprint of a replay buffer (its
    ``footprint()``: ``host_bytes``, ``disk_bytes``, ``device_bytes``)."""
    fp = getattr(buffer, "footprint", None)
    return {str(k): int(v) for k, v in fp().items()} if callable(fp) else {}


# ---------------------------------------------------------------------------
# error classification


def is_resource_exhausted(err: BaseException) -> bool:
    return isinstance(err, torch.cuda.OutOfMemoryError) or "out of memory" in str(err).lower()


def is_transfer_guard_error(err: BaseException) -> bool:
    return _SYNC_TEXT in str(err)


@contextmanager
def sync_guard(mode: str, device: Any) -> Iterator[List[str]]:
    """``torch.cuda.set_sync_debug_mode`` for the block, the previous mode
    restored after it; yields the list the ``log`` mode fills with one entry
    per synchronizing call (the warning's text).  A no-op off the card."""
    found: List[str] = []
    if mode == "off" or device is None or not str(device).startswith("cuda"):
        yield found
        return
    previous = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(_SYNC_MODES[mode])
        try:
            yield found
        finally:
            torch.cuda.set_sync_debug_mode(previous)
    for w in caught:
        if _SYNC_TEXT in str(w.message):
            found.append(f"{w.filename}:{w.lineno}")
        else:
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)


# ---------------------------------------------------------------------------
# the monitor


class MemoryMonitor:
    """Per-run memory and data-movement accounting behind the facade.

    Thread-safe counters (the metrics server snapshots from its own
    thread).  All journal writes go through the facade's ``journal_fn``."""

    def __init__(self, cfg: Optional[Mapping[str, Any]] = None):
        cfg = cfg or {}
        diag_cfg = (cfg.get("diagnostics") or {}) if cfg else {}
        mem_cfg = diag_cfg.get("memory") or {}
        self.enabled = bool(mem_cfg.get("enabled", True))
        self.transfer_mode = normalize_transfer_mode(diag_cfg.get("transfers"))
        self.hbm_enabled = bool(mem_cfg.get("hbm", True))
        self.audit_top_n = int(mem_cfg.get("audit_top_n", 20))
        self.replicated_warn_bytes = int(mem_cfg.get("replicated_warn_bytes", DEFAULT_REPLICATED_WARN_BYTES))
        inject_transfer = mem_cfg.get("inject_transfer_iter")
        self._inject_transfer_iter = None if inject_transfer is None else int(inject_transfer)
        inject_oom = mem_cfg.get("inject_oom_iter")
        self._inject_oom_iter = None if inject_oom is None else int(inject_oom)

        self._lock = threading.Lock()
        self._journal_fn: Optional[Callable[..., None]] = None
        self._sync_fn: Optional[Callable[[], None]] = None
        self._device: Any = None
        self._footprints: Dict[str, Any] = {}
        self._buffers: Dict[str, Any] = {}
        self._train_calls = 0
        self._breakdown_emitted = False
        self._shards: Optional[Tuple[List[Any], Dict[str, List[Any]]]] = None
        # armed by the facade's on_fsdp_shard_map: {"axis_size", "min_shard_bytes", "params_bytes_per_device"}
        self._fsdp: Optional[Dict[str, int]] = None
        self._sharding: Any = SHARDING_NOT_RUN
        self._hbm_source: Optional[str] = None
        self._latest: Dict[str, float] = {}
        self._last_syncs: Optional[int] = None
        # counters mirrored to /metrics
        self._host_transfers = 0
        self._oom_events = 0

    # -- lifecycle ---------------------------------------------------------
    def open(self, journal_fn: Optional[Callable[..., None]] = None, sync_fn: Optional[Callable[[], None]] = None,
             device: Any = None) -> None:
        self._journal_fn = journal_fn
        self._sync_fn = sync_fn
        self._device = device

    def _journal(self, event: str, **fields: Any) -> None:
        if self._journal_fn is not None:
            self._journal_fn(event, **fields)

    def _journal_synced(self, event: str, **fields: Any) -> None:
        """Journal and force the bytes to disk: the event must survive the
        process dying right afterwards."""
        self._journal(event, **fields)
        if self._sync_fn is not None:
            self._sync_fn()

    # -- component registration (called by the training loops) -------------
    def register_footprint(self, name: str, tree_or_bytes: Any) -> None:
        """Record a static component (params, optimizer state...) for the
        ``memory_breakdown`` event: a tree, module, optimizer or raw bytes.
        Its size is read when the breakdown is taken, after the first step:
        torch's Adam creates its state there."""
        if not self.enabled:
            return
        with self._lock:
            self._footprints[str(name)] = tree_or_bytes

    def register_shards(self, devices: List[Any], replicated: Mapping[str, List[Any]]) -> None:
        """The data axis's devices and, by name, each replicated tree as a
        list of the shards' replicas, for the ``sharding_audit`` of the
        first train dispatch."""
        if not self.enabled:
            return
        with self._lock:
            self._shards = (list(devices), dict(replicated))

    def note_fsdp(self, summary: Mapping[str, Any]) -> None:
        """Arm the FSDP accounting (the facade's ``on_fsdp_shard_map``): the
        ``Telemetry/fsdp_axis_size`` and ``Telemetry/params_bytes_per_device``
        gauges, and the sharding audit's ``min_shard_bytes`` exemption.  The
        bytes gauge reads what a shard holds between steps (the summary's
        ``held_bytes_per_device``), the rule's ``bytes_per_device``."""
        if not self.enabled:
            return
        held = summary.get("held_bytes_per_device") or {}
        with self._lock:
            self._fsdp = {"axis_size": int(summary.get("axis_size", 1) or 1),
                          "min_shard_bytes": int(summary.get("min_shard_bytes", 0) or 0),
                          "params_bytes_per_device": held.get("params")}

    def _sharding_audit(self, inst: Any, args: Tuple[Any, ...]) -> None:
        with self._lock:
            shards = self._shards
            fsdp = dict(self._fsdp) if self._fsdp else {}
        if shards is None:
            return
        table = sharding_table(shards[0], shards[1], list(args), top_n=self.audit_top_n,
                               replicated_warn_bytes=self.replicated_warn_bytes,
                               fsdp_axis_size=fsdp.get("axis_size"), fsdp_min_shard_bytes=fsdp.get("min_shard_bytes"))
        with self._lock:
            self._sharding = {k: table[k] for k in ("n_shards", "n_leaves", "total_bytes",
                                                     "total_bytes_per_device", "flagged_replicated")}
        self._journal("sharding_audit", fn=getattr(inst, "name", "?"), **table)

    def _component_bytes(self) -> Dict[str, int]:
        with self._lock:
            items = dict(self._footprints)
        return {name: int(v) if isinstance(v, (int, float)) else tree_bytes(v) for name, v in items.items()}

    def track_buffer(self, name: str, buffer: Any) -> None:
        """Track a replay buffer's footprint, re-read every metric interval."""
        if not self.enabled:
            return
        with self._lock:
            self._buffers[str(name)] = buffer

    # -- guarded dispatch ---------------------------------------------------
    def guarded_call(self, inst: Any, call: Callable[[], Any], args: Tuple[Any, ...], kwargs: Mapping[str, Any]):
        """Run one instrumented dispatch under the sync guard, with fault
        injection, the sync count and OOM forensics."""
        is_train = getattr(inst, "kind", "train") == "train"
        call_idx = 0
        if is_train:
            with self._lock:
                self._train_calls += 1
                call_idx = self._train_calls
        try:
            with sync_guard(self.transfer_mode, self._device) as syncs:
                if is_train and self._inject_oom_iter is not None and call_idx == self._inject_oom_iter:
                    self._inject_oom_iter = None
                    raise torch.cuda.OutOfMemoryError(
                        "CUDA out of memory: injected (diagnostics.memory.inject_oom_iter), OOM-forensics drill"
                    )
                out = call()
                if (is_train and self.transfer_mode != "off" and self._inject_transfer_iter is not None
                        and call_idx == self._inject_transfer_iter):
                    self._inject_transfer_iter = None
                    self._fire_transfer_injection(inst, call_idx, out)
        except Exception as err:
            self._handle_dispatch_error(inst, call_idx, err)
            raise
        if is_train and self.transfer_mode == "log":
            self._note_syncs(inst, call_idx, syncs)
        if is_train and not self._breakdown_emitted:
            self._breakdown_emitted = True
            self._sharding_audit(inst, args)
            self._journal("memory_breakdown", fn=getattr(inst, "name", "?"), **self.breakdown())
        return out

    def _note_syncs(self, inst: Any, call_idx: int, syncs: List[str]) -> None:
        """Count the synchronizing calls of one dispatch; journal the count
        whenever it differs from the last one journaled."""
        n = len(syncs)
        with self._lock:
            self._host_transfers += n
            changed = n != self._last_syncs
            self._last_syncs = n
        if changed:
            self._journal("host_transfer", fn=getattr(inst, "name", "?"), call=call_idx, direction="sync",
                          syncs_per_dispatch=n, policy=self.transfer_mode, sites=sorted(set(syncs))[:16])

    def _fire_transfer_injection(self, inst: Any, call_idx: int, out: Any) -> None:
        """The drill: one device->host copy of an output tensor inside the
        guarded scope (counted under ``log``; raises under ``disallow``)."""
        leaves = [t for t in _leaves(out) if isinstance(t, torch.Tensor)]
        synced_bytes = 0
        if leaves:
            synced_bytes = leaves[-1].cpu().numel() * leaves[-1].element_size()
        with self._lock:
            self._host_transfers += 1
        self._journal("host_transfer", fn=getattr(inst, "name", "?"), call=call_idx, direction="device_to_host",
                      injected=True, policy=self.transfer_mode, bytes=synced_bytes)

    def _handle_dispatch_error(self, inst: Any, call_idx: int, err: BaseException) -> None:
        if is_transfer_guard_error(err):
            with self._lock:
                self._host_transfers += 1
            self._journal_synced("host_transfer", fn=getattr(inst, "name", "?"), call=call_idx, blocked=True,
                                 policy=self.transfer_mode, error=str(err)[:300])
        elif is_resource_exhausted(err):
            with self._lock:
                self._oom_events += 1
            self._journal_synced("oom", fn=getattr(inst, "name", "?"), call=call_idx, error=str(err)[:500],
                                 **self._forensics_snapshot())

    def _forensics_snapshot(self) -> Dict[str, Any]:
        """What a post-mortem needs, gathered without raising over the real
        error."""
        snap: Dict[str, Any] = {}
        try:
            stats = device_memory_stats(self._device)
        except RuntimeError:
            stats = []
        if stats:
            snap["device_memory"] = stats
        rss = host_rss_bytes()
        if rss is not None:
            snap["host_rss_bytes"] = rss
        components = self._component_bytes()
        if components:
            snap["components"] = components
        with self._lock:
            buffers = dict(self._buffers)
        footprints = {name: buffer_footprint(buf) for name, buf in buffers.items()}
        footprints = {k: v for k, v in footprints.items() if v}
        if footprints:
            snap["buffers"] = footprints
        return snap

    def breakdown(self) -> Dict[str, Any]:
        """The static footprint decomposition (the ``memory_breakdown``
        payload)."""
        components = self._component_bytes()
        with self._lock:
            buffers = dict(self._buffers)
        for name, buf in buffers.items():
            for kind, size in buffer_footprint(buf).items():
                components[f"{name}_{kind}"] = size
        with self._lock:
            sharding = self._sharding
            fsdp = dict(self._fsdp) if self._fsdp else None
        out: Dict[str, Any] = {"components": components, "sharding_audit": sharding,
                               "donation_audit": DONATION_NOT_RUN}
        if fsdp:
            out["fsdp_axis_size"] = fsdp["axis_size"]
        stats = device_memory_stats(self._device)
        if stats:
            out["device_memory"] = stats
            out["source"] = "torch.cuda.memory_stats"
        else:
            out["source"] = "none"
        rss = host_rss_bytes()
        if rss is not None:
            out["host_rss_bytes"] = rss
        return out

    # -- interval gauges -----------------------------------------------------
    def interval_metrics(self) -> Dict[str, float]:
        """``Telemetry/hbm_*`` (on the card only), host RSS and the replay
        buffer's gauges for one metric interval."""
        if not (self.enabled and self.hbm_enabled):
            return {}
        out: Dict[str, float] = {}
        stats = device_memory_stats(self._device)
        if stats:
            self._hbm_source = "torch.cuda.memory_stats"
            out["Telemetry/hbm_bytes_in_use"] = float(max(s["bytes_in_use"] for s in stats))
            out["Telemetry/hbm_peak_bytes"] = float(max(s["peak_bytes_in_use"] for s in stats))
        else:
            self._hbm_source = "none"
        rss = host_rss_bytes()
        if rss is not None:
            out["Telemetry/host_rss_bytes"] = float(rss)
        with self._lock:
            fsdp = dict(self._fsdp) if self._fsdp else None
        if fsdp is not None:
            out["Telemetry/fsdp_axis_size"] = float(fsdp["axis_size"])
            if fsdp.get("params_bytes_per_device") is not None:
                out["Telemetry/params_bytes_per_device"] = float(fsdp["params_bytes_per_device"])
        with self._lock:
            buffers = dict(self._buffers)
        for name, buf in buffers.items():
            for kind, size in buffer_footprint(buf).items():
                out[f"Telemetry/{name}_{kind}"] = float(size)
        with self._lock:
            self._latest = dict(out)
        return out

    # -- snapshots (metrics server / run summary) ---------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "gauges": dict(self._latest),
                "counters": {
                    "host_transfers_total": self._host_transfers,
                    "donation_miss_leaves_total": 0,
                    "oom_events_total": self._oom_events,
                },
                "info": {"hbm_source": self._hbm_source, "transfer_guard": self.transfer_mode},
            }

    def summary(self) -> Dict[str, Any]:
        """Cumulative totals for the closing ``memory_summary`` event."""
        snap = self.snapshot()
        components = self._component_bytes()
        with self._lock:
            train_calls = self._train_calls
            sharding = self._sharding
        return {
            "host_transfers": snap["counters"]["host_transfers_total"],
            "train_dispatches": train_calls,
            "donation_miss_leaves": 0,
            "oom_events": snap["counters"]["oom_events_total"],
            "hbm_source": self._hbm_source,
            "transfer_guard": self.transfer_mode,
            "components": components,
            "sharding_audit": sharding,
            "donation_audit": DONATION_NOT_RUN,
        }
