"""JRN — journal event kinds and /metrics names against the schema registry.

``sheeprl_tpu_torch/diagnostics/schema.py`` is the single source of truth for the
journal's event-kind vocabulary and the Prometheus names the ``/metrics``
endpoint exports.  This pass parses the registry (AST only — never imported)
and cross-checks three surfaces:

1. every string-literal event kind passed to a journal emitter
   (``journal.write("<kind>", ...)``, ``self._journal("<kind>", ...)``,
   ``self._journal_event`` / ``_journal_synced``) anywhere under
   ``sheeprl_tpu_torch/`` must be registered in ``EVENT_KINDS``;
2. the event table in ``howto/diagnostics.md`` (the block between
   ``<!-- lint:event-table:begin -->`` and ``...end -->``) must list exactly
   the registered kinds — the doc is *verified generated* from the registry;
3. every metric-name literal in the diagnostics package — snapshot
   ``counters`` dict keys, full ``Telemetry/...`` gauge keys (including
   ``TELEMETRY_PREFIX + "..."`` concatenations), and ``sheeprl_*`` literals
   in ``metrics_server.py`` — must resolve to a ``METRICS`` entry, whose
   names must all start with ``sheeprl_``.

Rules:

* **JRN301** (error) — journal emitter called with an unregistered kind;
* **JRN302** (error) — doc event table out of sync with the registry
  (missing or phantom kind), or the marked block is absent;
* **JRN303** (error) — metric name literal not registered / not
  ``sheeprl_``-prefixed;
* **JRN304** (warning) — registered event kind no code path emits (registry
  rot; forwarding wrappers make this a warning, not an error).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from sheeprl_tpu_torch.tools.lint import Finding
from sheeprl_tpu_torch.tools.lint.loader import RepoIndex, call_name, const_str

SCHEMA_PATH = "sheeprl_tpu_torch/diagnostics/schema.py"
DIAG_PREFIX = "sheeprl_tpu_torch/diagnostics/"
DOC_PATH = "howto/diagnostics.md"
TABLE_BEGIN = "<!-- lint:event-table:begin -->"
TABLE_END = "<!-- lint:event-table:end -->"
# queue_journal_event: the resilience layer's deferred emission — events
# queued before the run journal exists are journaled verbatim at open
EMITTER_METHODS = {"_journal", "_journal_event", "_journal_synced", "queue_journal_event"}
TELEMETRY_GAUGE_RE = re.compile(r"^Telemetry/[A-Za-z0-9_]+(/[A-Za-z0-9_]+)*$")
METRIC_PREFIX = "sheeprl_"
METRICS_SERVER = "metrics_server.py"

RULES = {
    "JRN301": "journal event kind not declared in diagnostics/schema.py",
    "JRN302": "howto/diagnostics.md event table out of sync with the registry",
    "JRN303": "/metrics name not registered in schema.METRICS or not sheeprl_-prefixed",
    "JRN304": "registered event kind never emitted by any code path",
}


def _metric_name(key: str) -> str:
    """Mirror of ``metrics_server._metric_name`` (gauge key -> exported
    suffix); duplicated here because the lint never imports the runtime."""
    name = key.split("/", 1)[1] if key.startswith("Telemetry/") else key
    name = "".join(ch if (ch.isalnum() or ch == "_") else "_" for ch in name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _registry(index: RepoIndex) -> Tuple[Optional[Dict[str, int]], Optional[Set[str]], List[Finding]]:
    """(event kinds -> schema line, metric names, findings).  Nones when the
    schema file or its tables are missing (itself a finding)."""
    findings: List[Finding] = []
    tree = index.module(SCHEMA_PATH)
    if tree is None:
        findings.append(
            Finding("JRN301", "error", SCHEMA_PATH, 1, "schema registry file is missing")
        )
        return None, None, findings
    kinds: Optional[Dict[str, int]] = None
    metrics: Optional[Set[str]] = None
    for node in ast.walk(tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
            value = node.value
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            targets = [node.target.id]
            value = node.value
        else:
            continue
        if "EVENT_KINDS" in targets and isinstance(value, ast.Dict):
            kinds = {}
            for key in value.keys:
                name = const_str(key)
                if name is not None:
                    kinds[name] = key.lineno
        if "METRICS" in targets and isinstance(value, ast.Dict):
            metrics = {name for key in value.keys if (name := const_str(key)) is not None}
    if kinds is None:
        findings.append(
            Finding("JRN301", "error", SCHEMA_PATH, 1, "EVENT_KINDS dict not found in schema registry")
        )
    if metrics is None:
        findings.append(
            Finding("JRN303", "error", SCHEMA_PATH, 1, "METRICS dict not found in schema registry")
        )
    return kinds, metrics, findings


def _emitted_kinds(index: RepoIndex) -> List[Tuple[str, str, int]]:
    """(kind, file, line) for every literal-kind journal emission."""
    out: List[Tuple[str, str, int]] = []
    for path, tree in index.modules("sheeprl_tpu_torch/"):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            name = call_name(node)
            is_emitter = name in EMITTER_METHODS
            if name == "write" and isinstance(node.func, ast.Attribute):
                # journal.write / self.journal.write / self._journal.write —
                # NOT fp.write etc.
                recv = node.func.value
                recv_name = recv.id if isinstance(recv, ast.Name) else getattr(recv, "attr", "")
                is_emitter = recv_name in ("journal", "_journal", "run_journal")
            if not is_emitter:
                continue
            kind = const_str(node.args[0])
            if kind is not None:
                out.append((kind, path, node.lineno))
    return out


def _doc_table_kinds(doc: str) -> Optional[Set[str]]:
    begin = doc.find(TABLE_BEGIN)
    end = doc.find(TABLE_END)
    if begin < 0 or end < 0 or end < begin:
        return None
    kinds: Set[str] = set()
    for line in doc[begin:end].splitlines():
        line = line.strip()
        if not line.startswith("|") or line.startswith("|-") or line.startswith("| ---"):
            continue
        first_cell = line.split("|")[1] if line.count("|") >= 2 else ""
        if first_cell.strip().lower() == "event":
            continue
        kinds.update(re.findall(r"`([a-z][a-z0-9_]*)`", first_cell))
    return kinds


def _metric_literals(index: RepoIndex) -> List[Tuple[str, str, int]]:
    """(exported metric name, file, line) from the diagnostics package."""
    out: List[Tuple[str, str, int]] = []
    for path, tree in index.modules(DIAG_PREFIX):
        if path == SCHEMA_PATH:
            continue
        for node in ast.walk(tree):
            # counter snapshot keys: any dict literal carrying a "counters"
            # key whose value is itself a dict of constant keys
            if isinstance(node, ast.Dict):
                for key, value in zip(node.keys, node.values):
                    if const_str(key) == "counters" and isinstance(value, ast.Dict):
                        for counter_key in value.keys:
                            counter = const_str(counter_key)
                            if counter is not None:
                                out.append(
                                    (METRIC_PREFIX + counter, path, counter_key.lineno)
                                )
            # full gauge keys: "Telemetry/..." literals (and PREFIX + "...")
            elif isinstance(node, ast.Constant) and isinstance(node.value, str):
                text = node.value
                if TELEMETRY_GAUGE_RE.match(text):
                    out.append((METRIC_PREFIX + _metric_name(text), path, node.lineno))
                elif path.endswith(METRICS_SERVER) and re.fullmatch(r"sheeprl_[a-z0-9_]+", text):
                    # only the endpoint's own literals are exported names; a
                    # journal field elsewhere (run_start's
                    # package="sheeprl_tpu_torch") is not one
                    out.append((text, path, node.lineno))
            elif (
                isinstance(node, ast.BinOp)
                and isinstance(node.op, ast.Add)
                and isinstance(node.left, ast.Name)
                and node.left.id == "TELEMETRY_PREFIX"
            ):
                suffix = const_str(node.right)
                if suffix is not None:
                    out.append(
                        (METRIC_PREFIX + _metric_name("Telemetry/" + suffix), path, node.lineno)
                    )
        # emit("name", ...) literals in the metrics server
        if path.endswith(METRICS_SERVER):
            for node in ast.walk(tree):
                if isinstance(node, ast.Call) and call_name(node) == "emit" and node.args:
                    name = const_str(node.args[0])
                    if name is not None:
                        out.append((METRIC_PREFIX + name, path, node.lineno))
    return out


def run(index: RepoIndex) -> List[Finding]:
    kinds, metrics, findings = _registry(index)

    emitted = _emitted_kinds(index)
    if kinds is not None:
        for kind, path, line in emitted:
            if kind not in kinds:
                findings.append(
                    Finding(
                        "JRN301",
                        "error",
                        path,
                        line,
                        f"journal event kind `{kind}` is not declared in "
                        "diagnostics/schema.py EVENT_KINDS — register it (and add the "
                        "howto/diagnostics.md table row)",
                    )
                )
        emitted_set = {k for k, _, _ in emitted}
        for kind, line in sorted(kinds.items()):
            if kind not in emitted_set:
                findings.append(
                    Finding(
                        "JRN304",
                        "warning",
                        SCHEMA_PATH,
                        line,
                        f"event kind `{kind}` is registered but no code path emits it "
                        "(stale registry entry?)",
                    )
                )

        doc = index.doc(DOC_PATH)
        if doc is None:
            findings.append(
                Finding("JRN302", "error", DOC_PATH, 1, "howto/diagnostics.md not found")
            )
        else:
            doc_kinds = _doc_table_kinds(doc)
            if doc_kinds is None:
                findings.append(
                    Finding(
                        "JRN302",
                        "error",
                        DOC_PATH,
                        1,
                        f"event table markers `{TABLE_BEGIN}` / `{TABLE_END}` not found — "
                        "the table must be the lint-verified block",
                    )
                )
            else:
                for kind in sorted(set(kinds) - doc_kinds):
                    findings.append(
                        Finding(
                            "JRN302",
                            "error",
                            DOC_PATH,
                            1,
                            f"registered event kind `{kind}` is missing from the "
                            "howto/diagnostics.md event table",
                        )
                    )
                for kind in sorted(doc_kinds - set(kinds)):
                    findings.append(
                        Finding(
                            "JRN302",
                            "error",
                            DOC_PATH,
                            1,
                            f"event table documents `{kind}` which is not in "
                            "diagnostics/schema.py EVENT_KINDS",
                        )
                    )

    if metrics is not None:
        for name in sorted(metrics):
            if not name.startswith(METRIC_PREFIX):
                findings.append(
                    Finding(
                        "JRN303",
                        "error",
                        SCHEMA_PATH,
                        1,
                        f"registered metric `{name}` does not start with `{METRIC_PREFIX}`",
                    )
                )
        seen: Set[Tuple[str, str, int]] = set()
        for name, path, line in _metric_literals(index):
            if name not in metrics and (name, path, line) not in seen:
                seen.add((name, path, line))
                findings.append(
                    Finding(
                        "JRN303",
                        "error",
                        path,
                        line,
                        f"/metrics name `{name}` is not registered in "
                        "diagnostics/schema.py METRICS",
                    )
                )
    return findings
