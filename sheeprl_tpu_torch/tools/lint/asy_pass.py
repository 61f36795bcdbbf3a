"""ASY — split-phase env pipeline discipline.

The async env pipeline (``howto/async_envs.md``) is a strict two-phase
protocol: a loop that issues ``step_async`` twice on the same env without a
``step_wait`` between deadlocks the thread executor and corrupts the shm
executor's in-place buffers.  And the shm worker protocol's command bytes
are a wire format — a second module re-declaring them can drift silently.
Since the worker-sharding rework that format is PER WORKER (one
``_CMD_STEP`` down / one ack up covers a whole env slab, ``_CMD_RESET``
carries the slab's seed list), which makes a stray re-declaration even more
dangerous: a module assuming the old per-env protocol would deadlock a slab
worker mid-drain.

Scoping decisions that keep the pass honest:

* call sites are collected **per function, without crossing nested-function
  boundaries** — a helper's calls belong to the helper, not its enclosing
  scope;
* pairing is **per receiver** (``player_envs`` vs ``eval_envs`` are two
  independent streams, keyed by the attribute chain the method is called
  on);
* loop bodies are checked **cyclically** (iteration N's async is followed by
  iteration N+1's), so the prime-then-wait-at-top idiom passes;
* a lone ``step_async`` with no following event in its function is NOT
  flagged — the matching wait may live in a caller; only a provably adjacent
  second ``step_async`` (or an async-bearing loop with no wait at all) is an
  error.

Rules:

* **ASY401** (error) — two ``step_async`` issues on the same receiver with
  no ``step_wait`` between them (cyclic within loop bodies, linear across a
  function's straight-line code);
* **ASY402** (error) — a shm-executor command/ack byte constant
  (``_CMD_*`` / ``_ACK_*`` assigned a bytes literal) defined outside
  ``sheeprl_tpu_torch/envs/executor.py`` — the protocol lives in exactly one
  module.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, List, Tuple

from sheeprl_tpu_torch.tools.lint import Finding
from sheeprl_tpu_torch.tools.lint.loader import RepoIndex, attr_chain, call_name

EXECUTOR_MODULE = "sheeprl_tpu_torch/envs/executor.py"
CMD_NAME_RE = re.compile(r"^_?(CMD|ACK)_[A-Z0-9_]+$")

RULES = {
    "ASY401": "step_async reissued on a receiver before its step_wait",
    "ASY402": "shm-executor command byte defined outside the executor module",
}

#: (kind, line, receiver) — receiver is the attribute chain the method is
#: called on ("envs", "self._env", ...), "?" when not a plain chain
Event = Tuple[str, int, str]


def _walk_shallow(node: ast.AST) -> Iterator[ast.AST]:
    """Descendants of ``node`` without entering nested function defs."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield child
        stack.extend(ast.iter_child_nodes(child))


def _events(node: ast.AST) -> List[Event]:
    """step_async/step_wait call sites under ``node`` in source order."""
    out: List[Event] = []
    for child in _walk_shallow(node):
        if isinstance(child, ast.Call):
            name = call_name(child)
            if name in ("step_async", "step_wait"):
                recv = "?"
                if isinstance(child.func, ast.Attribute):
                    chain = attr_chain(child.func)
                    if chain is not None:
                        recv = ".".join(chain[:-1])
                out.append(("async" if name == "step_async" else "wait", child.lineno, recv))
    out.sort(key=lambda e: e[1])
    return out


def _receivers(events: List[Event]) -> List[str]:
    return sorted({recv for _, _, recv in events})


def _check_loop(events: List[Event], rel: str, findings: List[Finding]) -> None:
    """Cyclic per-receiver pairing within one loop body."""
    for recv in _receivers(events):
        stream = [e for e in events if e[2] == recv]
        asyncs = [e for e in stream if e[0] == "async"]
        if not asyncs:
            continue
        if not any(e[0] == "wait" for e in stream):
            findings.append(
                Finding(
                    "ASY401",
                    "error",
                    rel,
                    asyncs[0][1],
                    f"step_async on `{recv}` inside a loop with no step_wait on the "
                    "same receiver anywhere in the loop — every iteration reissues "
                    "with the previous step still in flight",
                )
            )
            continue
        seq = stream + stream  # the loop body repeats
        pending = False
        for i, (kind, line, _) in enumerate(seq):
            if kind == "async":
                if pending and i <= len(stream):
                    findings.append(
                        Finding(
                            "ASY401",
                            "error",
                            rel,
                            line,
                            f"step_async on `{recv}` follows an earlier step_async with "
                            "no step_wait between them (cyclic order: a loop body "
                            "repeats) — the second issue deadlocks/corrupts the "
                            "pipelined env",
                        )
                    )
                    break
                pending = True
            else:
                pending = False


def _check_linear(events: List[Event], loop_lines: set, rel: str, findings: List[Finding]) -> None:
    """Straight-line (non-loop) issues: a priming step_async whose very next
    same-receiver event is another step_async is a provable double issue —
    whether the second sits inline or first inside the loop that follows."""
    for recv in _receivers(events):
        stream = [e for e in events if e[2] == recv]
        for i, (kind, line, _) in enumerate(stream):
            if kind != "async" or line in loop_lines:
                continue
            rest = stream[i + 1 :]
            if rest and rest[0][0] == "async":
                findings.append(
                    Finding(
                        "ASY401",
                        "error",
                        rel,
                        rest[0][1],
                        f"step_async on `{recv}` follows a priming step_async with no "
                        "step_wait between them — the second issue deadlocks/corrupts "
                        "the pipelined env",
                    )
                )


def run(index: RepoIndex) -> List[Finding]:
    findings: List[Finding] = []
    for path, tree in index.modules("sheeprl_tpu_torch/"):
        # a module that names neither method has no event to pair
        source = index.py_source(path) or ""
        paired = "step_async" in source or "step_wait" in source
        for fn in ast.walk(tree) if paired else ():
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name == "step_async":
                # a pipeline wrapper's own step_async forwards to the inner
                # env's step_async — the matching wait lives in its sibling
                continue
            loops = [n for n in _walk_shallow(fn) if isinstance(n, (ast.For, ast.While))]
            loop_lines = set()
            for loop in loops:
                events = _events(loop)
                loop_lines.update(line for _, line, _ in events)
                _check_loop(events, path, findings)
            _check_linear(_events(fn), loop_lines, path, findings)
        # command-byte constants outside the canonical module
        if path != EXECUTOR_MODULE:
            for node in ast.walk(tree):
                if not isinstance(node, ast.Assign):
                    continue
                names = [t.id for t in node.targets if isinstance(t, ast.Name)]
                is_bytes = isinstance(node.value, ast.Constant) and isinstance(
                    node.value.value, bytes
                )
                for name in names:
                    if CMD_NAME_RE.match(name) and is_bytes:
                        findings.append(
                            Finding(
                                "ASY402",
                                "error",
                                path,
                                node.lineno,
                                f"shm command byte `{name}` defined outside "
                                f"{EXECUTOR_MODULE} — the worker wire protocol must "
                                "live in exactly one module",
                            )
                        )
    # nested loops overlap (outer walk includes inner loop bodies): keep one
    # finding per site
    unique: List[Finding] = []
    seen = set()
    for finding in findings:
        key = (finding.rule, finding.file, finding.line, finding.message)
        if key not in seen:
            seen.add(key)
            unique.append(finding)
    return unique
