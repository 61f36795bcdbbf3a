"""sheeprl-lint over the port: static analysis of ``sheeprl_tpu_torch/``.

The port's own copy of the repo's ``tools/lint/`` framework (it imports
nothing of it, no torch and no jax): structured :class:`Finding` records,
the pass registry, and the JSON baseline that suppresses accepted findings.
Seven pass families (one module each):

* **INS** (:mod:`.ins_pass`) — the shared training loops stay wired into
  the diagnostics facade through ``diag.instrument``, and the guarded step
  builders compute ``health_stats`` (INS001/003, donation, are listed and
  never fire: torch has no buffer donation);
* **JIT** (:mod:`.jit_pass`) — purity of the step bodies: no host RNG,
  wall clocks, host syncs or prints inside what the loops dispatch;
* **CFG** (:mod:`.cfg_pass`) — the YAML config tree and the ``cfg.*``
  accesses that consume it agree: no typo'd accesses, no dead keys, no
  unquoted YAML-1.1 bool strings;
* **JRN** (:mod:`.jrn_pass`) — every journal event kind and ``/metrics``
  name is declared in ``sheeprl_tpu_torch/diagnostics/schema.py`` and
  documented;
* **ASY** (:mod:`.asy_pass`) — split-phase env discipline: every
  ``step_async`` is matched by a ``step_wait`` before the next one, and the
  shm-executor command bytes live in exactly one module;
* **TRC** (:mod:`.trc_pass`) — trace hygiene: every literal span name
  resolves to ``tracing.KNOWN_PHASES``, and serving histogram bucket
  boundaries come from ``serving.slo.buckets_ms`` config, never inline;
* **LCK** (:mod:`.lck_pass`) — lock discipline for the threaded runtime:
  a per-module thread model plus a call graph classifies shared attributes
  and requires every shared access to sit under one lock; journal emissions
  and blocking calls under contended monitor locks are flagged, and
  ``Event``/``Condition`` waits must not park forever.

A finding's baseline key is ``(rule, file, message)`` — line numbers drift
with unrelated edits, so they are display-only.  Every baseline entry carries
a mandatory one-line ``why``; ``--update-baseline`` preserves existing
justifications and stamps new entries with a TODO a maintainer must replace.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from sheeprl_tpu_torch.tools.lint.loader import RepoIndex

SEVERITIES = ("error", "warning")


def rule_family(rule: str) -> str:
    """``CFG202`` -> ``CFG`` (the pass family a rule id belongs to)."""
    return rule.rstrip("0123456789")


@dataclass(frozen=True)
class Finding:
    rule: str
    severity: str
    file: str
    line: int
    message: str

    def key(self) -> str:
        return f"{self.rule} :: {self.file} :: {self.message}"

    def render(self) -> str:
        return f"{self.file}:{self.line} · {self.rule} · {self.severity} · {self.message}"

    def as_dict(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "file": self.file,
            "line": self.line,
            "message": self.message,
        }


def get_passes() -> Dict[str, object]:
    """Family id -> pass module (each exposes ``run(index) -> List[Finding]``
    and a ``RULES`` catalog).  Imported lazily so the loader stays importable
    from the back-compat shim without pulling every pass."""
    from sheeprl_tpu_torch.tools.lint import asy_pass, cfg_pass, ins_pass, jit_pass, jrn_pass, lck_pass, trc_pass

    return {
        "INS": ins_pass,
        "JIT": jit_pass,
        "CFG": cfg_pass,
        "JRN": jrn_pass,
        "ASY": asy_pass,
        "TRC": trc_pass,
        "LCK": lck_pass,
    }


def rule_catalog() -> Dict[str, str]:
    """Rule id -> one-line description, across every registered pass."""
    catalog: Dict[str, str] = {}
    for module in get_passes().values():
        catalog.update(module.RULES)
    return catalog


def run_passes(
    index: RepoIndex, families: Optional[List[str]] = None, jobs: int = 1
) -> List[Finding]:
    """Run the selected pass families over ``index``.  ``jobs > 1`` runs the
    families on a thread pool — they are independent read-only walks over the
    parsed AST/YAML corpus, and the final sort makes the output order
    identical to a sequential run."""
    passes = get_passes()
    selected = list(passes) if not families else [f for f in passes if f in families]
    findings: List[Finding] = []
    for path, message in index.parse_errors:
        findings.append(Finding("LINT000", "error", path, 1, message))
    if jobs > 1 and len(selected) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(jobs, len(selected))) as pool:
            for batch in pool.map(lambda family: passes[family].run(index), selected):
                findings.extend(batch)
    else:
        for family in selected:
            findings.extend(passes[family].run(index))
    findings.sort(key=lambda f: (f.file, f.line, f.rule, f.message))
    return findings


# -- baseline --------------------------------------------------------------
def load_baseline(path: str) -> Dict[str, Dict[str, str]]:
    """Baseline file -> ``{finding key: entry}``.  Missing file = empty."""
    try:
        with open(path, encoding="utf-8") as fp:
            data = json.load(fp)
    except FileNotFoundError:
        return {}
    entries = {}
    for entry in data.get("entries", []):
        key = f"{entry['rule']} :: {entry['file']} :: {entry['message']}"
        entries[key] = entry
    return entries


def split_baseline_by_family(
    baseline: Dict[str, Dict[str, str]], families: Optional[List[str]]
) -> Tuple[Dict[str, Dict[str, str]], Dict[str, Dict[str, str]]]:
    """(in-scope, out-of-scope) entries for a ``--rules`` subset run.  An
    entry whose pass family did not run can be neither matched nor judged
    stale — and ``--update-baseline`` must carry it through untouched."""
    if not families:
        return dict(baseline), {}
    in_scope, out_of_scope = {}, {}
    for key, entry in baseline.items():
        family = rule_family(entry.get("rule", ""))
        target = in_scope if (family in families or family == "LINT") else out_of_scope
        target[key] = entry
    return in_scope, out_of_scope


def apply_baseline(
    findings: List[Finding], baseline: Dict[str, Dict[str, str]]
) -> Tuple[List[Finding], List[Finding], List[Dict[str, str]]]:
    """Split findings into (active, suppressed) and return baseline entries
    that no longer match anything (stale — safe to delete)."""
    active: List[Finding] = []
    suppressed: List[Finding] = []
    seen_keys = set()
    for finding in findings:
        key = finding.key()
        seen_keys.add(key)
        (suppressed if key in baseline else active).append(finding)
    stale = [entry for key, entry in baseline.items() if key not in seen_keys]
    return active, suppressed, stale


def write_baseline(
    path: str,
    findings: List[Finding],
    old: Dict[str, Dict[str, str]],
    keep: Optional[Dict[str, Dict[str, str]]] = None,
) -> int:
    """Rewrite the baseline to exactly the current findings, preserving the
    ``why`` of entries that survive; ``keep`` entries (families a ``--rules``
    subset run did not execute) are carried through verbatim.  Returns the
    number of NEW entries (ones whose justification is still the TODO
    placeholder)."""
    entries = []
    new = 0
    seen_keys = set()
    for finding in sorted(findings, key=lambda f: f.key()):
        # messages deliberately carry no line numbers, so two occurrences of
        # the same violation in one file share a key — one entry covers both
        if finding.key() in seen_keys:
            continue
        seen_keys.add(finding.key())
        prior = old.get(finding.key())
        why = (prior or {}).get("why", "")
        if not why or why.startswith("TODO"):
            if prior is None:
                new += 1
            why = why or "TODO: justify this suppression (one line) or fix the finding"
        entries.append(
            {
                "rule": finding.rule,
                "file": finding.file,
                "message": finding.message,
                "why": why,
            }
        )
    for key in sorted(keep or {}):
        entry = (keep or {})[key]
        entries.append(
            {
                "rule": entry.get("rule", ""),
                "file": entry.get("file", ""),
                "message": entry.get("message", ""),
                "why": entry.get("why", ""),
            }
        )
    entries.sort(key=lambda e: (e["rule"], e["file"], e["message"]))
    payload = {
        "_comment": (
            "Accepted sheeprl-lint findings. Keyed by (rule, file, message) — line "
            "numbers drift and are not part of the key. Every entry MUST carry a "
            "one-line human 'why'. Regenerate with: python -m "
            "sheeprl_tpu_torch.tools.sheeprl_lint --update-baseline (existing whys are preserved)."
        ),
        "entries": entries,
    }
    with open(path, "w", encoding="utf-8") as fp:
        json.dump(payload, fp, indent=2, sort_keys=False)
        fp.write("\n")
    return new
