"""TRC — trace-span vocabulary and serving histogram-bucket hygiene.

``sheeprl_tpu_torch/diagnostics/tracing.py`` owns the phase vocabulary: the
``KNOWN_PHASES`` tuple is the closed set of span names ``tools/trace_report.py``
aggregates and the docs describe.  A span emitted under an off-registry name
still renders in Perfetto but silently falls out of every per-phase table —
a typo'd ``"serve-dipatch"`` is invisible exactly when someone is debugging
dispatch latency.  This pass parses the registry (AST only — never imported)
and cross-checks two surfaces:

1. every **string-literal** first argument to a ``.span(...)`` or
   ``.emit_complete(...)`` call on ANY receiver (``diag.span``,
   ``self._tracer.span``, ``tracer.emit_complete`` — the training loops and
   the serving tier use different facades for the same tracer) must be a
   member of ``KNOWN_PHASES``.  Dynamic names (``tracer.span(name)``) and
   argument-less ``.span()`` calls (``re.Match.span()``) are skipped, as is
   ``instant(...)`` — instant markers like ``ckpt_promote`` are events, not
   phases;
2. serving histogram bucket boundaries come from config
   (``serving.slo.buckets_ms``), never from inline magic-number literals:
   under ``sheeprl_tpu_torch/serving/``, a list/tuple literal of numbers bound to
   a ``*buckets_ms*`` name — as a call keyword or an assignment target — is
   flagged unless the target is an ALL-CAPS module constant (the single
   declared fallback, e.g. ``DEFAULT_SLO_BUCKETS_MS``).  Inline boundaries
   drift from the config the dashboards are tuned to, and two sources of
   bucket edges make cross-model aggregation quietly re-bin.

Rules:

* **TRC501** (error) — span/complete-event name literal not in
  ``tracing.KNOWN_PHASES``;
* **TRC502** (error) — serving histogram bucket literals inline instead of
  from ``serving.slo.buckets_ms`` config.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from sheeprl_tpu_torch.tools.lint import Finding
from sheeprl_tpu_torch.tools.lint.loader import RepoIndex, const_str

TRACING_PATH = "sheeprl_tpu_torch/diagnostics/tracing.py"
SERVING_PREFIX = "sheeprl_tpu_torch/serving/"
SPAN_METHODS = ("span", "emit_complete")
BUCKET_NAME_FRAGMENT = "buckets_ms"

RULES = {
    "TRC501": "trace span name not declared in tracing.KNOWN_PHASES",
    "TRC502": "serving histogram buckets inlined instead of read from serving.slo.buckets_ms",
}


def _known_phases(index: RepoIndex) -> Tuple[Optional[Set[str]], List[Finding]]:
    """Parse the ``KNOWN_PHASES`` tuple out of the tracing module (None plus
    a finding when the registry is missing — every other check then skips)."""
    findings: List[Finding] = []
    tree = index.module(TRACING_PATH)
    if tree is None:
        findings.append(
            Finding("TRC501", "error", TRACING_PATH, 1, "tracing module is missing")
        )
        return None, findings
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == "KNOWN_PHASES" for t in node.targets):
            continue
        if isinstance(node.value, (ast.Tuple, ast.List)):
            phases = {name for e in node.value.elts if (name := const_str(e)) is not None}
            return phases, findings
    findings.append(
        Finding(
            "TRC501",
            "error",
            TRACING_PATH,
            1,
            "KNOWN_PHASES tuple not found in the tracing module",
        )
    )
    return None, findings


def _is_numeric_literal_seq(node: ast.AST) -> bool:
    """A list/tuple literal whose elements are all plain numbers (the shape
    of an inlined bucket-boundary table; an empty literal is not one)."""
    if not isinstance(node, (ast.List, ast.Tuple)) or not node.elts:
        return False
    return all(
        isinstance(e, ast.Constant) and isinstance(e.value, (int, float)) and not isinstance(e.value, bool)
        for e in node.elts
    )


def _check_spans(index: RepoIndex, phases: Set[str]) -> List[Finding]:
    findings: List[Finding] = []
    for path, tree in index.modules():
        if path == TRACING_PATH:
            continue  # the registry module's own docstrings/definitions
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            # method-call form only: a bare `span(...)` name is something
            # else's API, and `.instant(...)` markers are not phases
            if not isinstance(node.func, ast.Attribute) or node.func.attr not in SPAN_METHODS:
                continue
            name = const_str(node.args[0])
            if name is None or name in phases:
                continue
            findings.append(
                Finding(
                    "TRC501",
                    "error",
                    path,
                    node.lineno,
                    f"span name `{name}` is not in tracing.KNOWN_PHASES — "
                    "register it there (trace_report's per-phase table drops "
                    "unknown names silently)",
                )
            )
    return findings


def _check_buckets(index: RepoIndex) -> List[Finding]:
    findings: List[Finding] = []
    for path, tree in index.modules(SERVING_PREFIX):
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if (
                        kw.arg is not None
                        and BUCKET_NAME_FRAGMENT in kw.arg
                        and _is_numeric_literal_seq(kw.value)
                    ):
                        findings.append(
                            Finding(
                                "TRC502",
                                "error",
                                path,
                                kw.value.lineno,
                                f"inline bucket boundaries passed as `{kw.arg}=` — read "
                                "them from serving.slo.buckets_ms config so dashboards "
                                "and cross-model aggregation share one bucket table",
                            )
                        )
            elif isinstance(node, ast.Assign) and _is_numeric_literal_seq(node.value):
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        target_name = target.id
                        if target_name.isupper():
                            continue  # the declared module-constant fallback
                    elif isinstance(target, ast.Attribute):
                        target_name = target.attr
                    else:
                        continue
                    if BUCKET_NAME_FRAGMENT in target_name:
                        findings.append(
                            Finding(
                                "TRC502",
                                "error",
                                path,
                                node.lineno,
                                f"inline bucket boundaries assigned to `{target_name}` — "
                                "read them from serving.slo.buckets_ms config (an "
                                "ALL-CAPS module constant is the only allowed fallback)",
                            )
                        )
    return findings


def run(index: RepoIndex) -> List[Finding]:
    phases, findings = _known_phases(index)
    if phases is not None:
        findings.extend(_check_spans(index, phases))
    findings.extend(_check_buckets(index))
    return findings
