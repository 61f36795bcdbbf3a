"""INS — instrumentation wiring of the port's training loops.

The observability stack (signature watchdog, FLOP/MFU accounting, the sync
guard, OOM forensics, goodput's progress notes) only sees steps that
dispatch through ``diag.instrument``.  This pass is the repo's
``tools/lint/ins_pass.py`` over the port's structure: the flagship map names
the shared loops the port's algorithms run through, not one file per
algorithm.

Rules:

* **INS001** — not applicable to the port: the JAX rule asks a ``jax.jit``
  inside a ``make_train_step*`` builder to declare ``donate_argnums``;
  eager PyTorch has no buffer donation, so the rule never fires here;
* **INS002** — ``train_step = ...`` outside a step builder is assigned from
  something other than a ``*.instrument(...)`` call (inside a
  ``make_train_step*`` / ``make_update*`` builder the name is the raw step
  the loop instruments);
* **INS003** — not applicable to the port (donation, as INS001);
* **INS004 / INS005** — a flagship loop function has no ``kind="train"`` /
  ``kind="rollout"`` instrument call;
* **INS006** — a flagship loop file or function vanished (moved without
  updating this map);
* **INS007** — a guarded (sentinel-instrumented) train-step builder does not
  call ``health_stats``: the learning-dynamics layer only sees steps that
  compute the stats.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from sheeprl_tpu_torch.tools.lint import Finding
from sheeprl_tpu_torch.tools.lint.loader import RepoIndex, call_name, keyword_value

PACKAGE_PREFIX = "sheeprl_tpu_torch/"

# loops REQUIRED to dispatch through diag.instrument, keyed by
# package-relative path: (the loop function, or None for every function of
# the file, whether it instruments a rollout).  _on_policy_main runs PPO,
# A2C and PPO-recurrent; off_policy_main SAC, DroQ and SAC-AE; _dreamer_main
# DreamerV3, JEPA, P2E-DV3/DV2/DV1, DreamerV2 and DreamerV1; offline/train.py
# the offline loops; the decoupled player/trainer loops instrument the
# player's policy forward and the trainer shards' update in their ``main``.
FLAGSHIP = {
    "algos/ppo/ppo.py": ("_on_policy_main", True),
    "algos/ppo/ppo_decoupled.py": ("main", True),
    "algos/sac/sac.py": ("off_policy_main", True),
    "algos/sac/sac_decoupled.py": ("main", True),
    "algos/dreamer_v3/dreamer_v3.py": ("_dreamer_main", False),
    "offline/train.py": (None, False),
}

# Guarded train-step builders that must call health_stats.  The port's JEPA
# step is DreamerV3's builder with a JEPA term (its ``health_groups`` add the
# "jepa" module), and the P2E, DreamerV1/V2 and PPO-recurrent steps follow
# their JAX steps, which return no health stats.
HEALTH_REQUIRED = frozenset(
    {
        "algos/ppo/ppo.py",
        "algos/a2c/a2c.py",
        "algos/sac/sac.py",
        "algos/dreamer_v3/dreamer_v3.py",
    }
)

BUILDER_PREFIXES = ("make_train_step", "make_update")

RULES = {
    "INS001": "jit inside a make_train_step builder without donate_argnums "
    "(not applicable to the port: torch has no buffer donation)",
    "INS002": "train_step assigned without going through diag.instrument",
    "INS003": "instrument(kind='train') without a donate_argnums declaration "
    "(not applicable to the port: torch has no buffer donation)",
    "INS004": "flagship loop has no instrument(kind='train') call",
    "INS005": "flagship loop has no instrument(kind='rollout') call",
    "INS006": "flagship loop file or function not found",
    "INS007": "guarded train-step builder does not wire health_stats",
}


def _instrument_kind(node: ast.Call) -> Optional[str]:
    """The kind of a ``*.instrument(...)`` call (default 'train'), or None if
    the node is not an instrument call."""
    if call_name(node) != "instrument":
        return None
    kind = keyword_value(node, "kind")
    if kind is None:
        return "train"
    if isinstance(kind, ast.Constant) and isinstance(kind.value, str):
        return kind.value
    return "?"


class _Scanner(ast.NodeVisitor):
    def __init__(self, rel_path: str):
        self.rel_path = rel_path
        self.findings: List[Finding] = []
        #: (enclosing top-level function, kind) of every instrument call
        self.instrument_kinds: List[tuple] = []
        self.functions: set = set()
        self.health_stats_in_builder = False
        self._fn_stack: List[str] = []

    def _in_builder(self) -> bool:
        return any(name.startswith(BUILDER_PREFIXES) for name in self._fn_stack)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if not self._fn_stack:
            self.functions.add(node.name)
        self._fn_stack.append(node.name)
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # pragma: no cover - no async defs

    def visit_Call(self, node: ast.Call) -> None:
        if call_name(node) == "health_stats" and self._in_builder():
            self.health_stats_in_builder = True
        kind = _instrument_kind(node)
        if kind is not None:
            self.instrument_kinds.append((self._fn_stack[0] if self._fn_stack else None, kind))
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        # `train_step = <expr>` in a loop: the expr must be a *.instrument(...) call
        targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if "train_step" in targets and not self._in_builder():
            value = node.value
            if not (isinstance(value, ast.Call) and call_name(value) == "instrument"):
                self.findings.append(
                    Finding(
                        "INS002",
                        "error",
                        self.rel_path,
                        node.lineno,
                        "`train_step = ...` is not dispatched through diag.instrument — "
                        "no watchdog/MFU/sync-guard/OOM-forensics on this loop",
                    )
                )
        self.generic_visit(node)


def scan_trees(trees: Dict[str, ast.Module], file_prefix: str = PACKAGE_PREFIX) -> List[Finding]:
    """Scan parsed modules keyed by package-relative path; ``file_prefix``
    is prepended to reported paths."""
    findings: List[Finding] = []
    seen_flagship = set()
    for rel in sorted(trees):
        scanner = _Scanner(file_prefix + rel)
        scanner.visit(trees[rel])
        findings.extend(scanner.findings)
        if rel in HEALTH_REQUIRED and not scanner.health_stats_in_builder:
            findings.append(
                Finding(
                    "INS007",
                    "error",
                    file_prefix + rel,
                    1,
                    "guarded train-step builder does not call health_stats — the "
                    "learning-dynamics layer (Telemetry/health/*, anomaly detectors) "
                    "is blind to this loop",
                )
            )
        spec = FLAGSHIP.get(rel)
        if spec is None:
            continue
        loop_fn, rollout = spec
        if loop_fn is not None and loop_fn not in scanner.functions:
            continue  # reported as INS006 below
        seen_flagship.add(rel)
        kinds = [kind for fn, kind in scanner.instrument_kinds if loop_fn is None or fn == loop_fn]
        where = f"`{loop_fn}`" if loop_fn else "this loop"
        if "train" not in kinds:
            findings.append(
                Finding(
                    "INS004",
                    "error",
                    file_prefix + rel,
                    1,
                    f'no instrument(..., kind="train") call in {where} — train step unobserved',
                )
            )
        if rollout and "rollout" not in kinds:
            findings.append(
                Finding(
                    "INS005",
                    "error",
                    file_prefix + rel,
                    1,
                    f'no instrument(..., kind="rollout") call in {where} — rollout unobserved',
                )
            )
    for missing in sorted(set(FLAGSHIP) - seen_flagship):
        loop_fn = FLAGSHIP[missing][0]
        what = f"flagship loop `{loop_fn}`" if loop_fn else "flagship loop file"
        findings.append(
            Finding(
                "INS006",
                "error",
                file_prefix + missing,
                1,
                f"{what} not found (moved? update sheeprl_tpu_torch/tools/lint/ins_pass.py)",
            )
        )
    return findings


def run(index: RepoIndex) -> List[Finding]:
    trees = {path[len(PACKAGE_PREFIX) :]: tree for path, tree in index.modules(PACKAGE_PREFIX)}
    return scan_trees(trees)
