"""JIT — purity of the port's step bodies.

The repo's ``tools/lint/jit_pass.py`` guards what ``jax.jit`` traces.  The
port runs eagerly, so its "traced bodies" are the steps the loops dispatch:
every function passed to a ``*.instrument(...)`` call, every function a
``make_train_step*`` / ``make_update*`` builder returns, and, as a
transitive closure, every same-module function such a body references by
name (a ``loss`` called inside an ``update`` runs on every step just the
same).  On the card each step is already host-bound, so a blocking host sync
inside one stalls the launch queue of every step, and CUDA-graph capture of
the step refuses it.  The rules keep the JAX pass's ids:

* **JIT101** — host RNG in a step body: ``np.random.*``, stdlib
  ``random.*``, or a torch sampling call without an explicit
  ``generator=`` (the port's steps draw from a ``torch.Generator`` they are
  given, so a run and its resume draw the same stream);
* **JIT102** — wall clock (``time.time`` / ``perf_counter`` / ``monotonic``
  / ``time_ns`` / ``process_time``) in a step body;
* **JIT103** — blocking host sync in a step body: ``.item()``, ``.cpu()``,
  ``.numpy()``, ``.tolist()``, ``torch.cuda.synchronize()``;
* **JIT104** — bare ``print`` in a step body;
* **JIT105** — ``float()`` / ``int()`` / ``bool()`` on a tensor argument of
  a step body (a silent host sync); an argument annotated ``int``,
  ``float``, ``bool`` or ``str`` is a host value and exempt.
"""

from __future__ import annotations

import ast
from typing import List, Set

from sheeprl_tpu_torch.tools.lint import Finding
from sheeprl_tpu_torch.tools.lint.loader import RepoIndex, attr_chain, call_name

PACKAGE_PREFIX = "sheeprl_tpu_torch/"
BUILDER_PREFIXES = ("make_train_step", "make_update")
CLOCK_FNS = ("time", "perf_counter", "monotonic", "time_ns", "process_time")
STDLIB_RANDOM_FNS = (
    "random",
    "randint",
    "uniform",
    "choice",
    "choices",
    "shuffle",
    "sample",
    "randrange",
    "gauss",
    "normalvariate",
)
#: torch's samplers: ``torch.<fn>(...)`` draws from the global stream unless
#: given ``generator=``
TORCH_RANDOM_FNS = (
    "rand",
    "randn",
    "randint",
    "randperm",
    "rand_like",
    "randn_like",
    "randint_like",
    "normal",
    "bernoulli",
    "multinomial",
    "poisson",
)
#: in-place samplers on a tensor: ``x.uniform_(...)`` and the like
TENSOR_RANDOM_METHODS = (
    "uniform_",
    "normal_",
    "exponential_",
    "bernoulli_",
    "random_",
    "geometric_",
    "log_normal_",
    "cauchy_",
)
SYNC_METHODS = ("item", "cpu", "numpy", "tolist")
HOST_ANNOTATIONS = ("int", "float", "bool", "str")

RULES = {
    "JIT101": "host RNG (np.random/stdlib random/torch sampling without generator=) inside a step body",
    "JIT102": "wall clock read inside a step body",
    "JIT103": "blocking host sync (.item/.cpu/.numpy/.tolist/torch.cuda.synchronize) inside a step body",
    "JIT104": "bare print inside a step body",
    "JIT105": "float/int/bool on a tensor argument of a step body",
}


def _returned_names(builder: ast.AST) -> Set[str]:
    """Names a builder returns (``return update``), not entering nested
    defs: the step functions it hands the loop."""
    names: Set[str] = set()
    stack = list(builder.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Name):
            names.add(node.value.id)
        stack.extend(ast.iter_child_nodes(node))
    return names


def _traced_roots(tree: ast.Module) -> List[ast.AST]:
    """Step bodies of the module, as a transitive closure: functions passed
    to ``instrument(...)`` (by name, or as ``obj.method``), functions the
    step builders return, and every same-module function they reference."""
    by_name: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(node.name, []).append(node)
    step_names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and call_name(node) == "instrument" and len(node.args) >= 2:
            # diag.instrument("name", fn, ...)
            arg = node.args[1]
            if isinstance(arg, ast.Name):
                step_names.add(arg.id)
            elif isinstance(arg, ast.Attribute):
                step_names.add(arg.attr)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node.name.startswith(BUILDER_PREFIXES):
            step_names |= _returned_names(node)
    roots: List[ast.AST] = []
    seen: Set[int] = set()

    def add(fn: ast.AST) -> None:
        if id(fn) in seen:
            return
        seen.add(id(fn))
        roots.append(fn)
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                for target in by_name.get(node.id, []):
                    add(target)

    for name in sorted(step_names):
        for fn in by_name.get(name, []):
            add(fn)
    return roots


def _tensor_params(fn: ast.AST) -> Set[str]:
    """Parameters of ``fn`` and its nested defs that may hold tensors: all
    but ``self`` and those annotated as host scalars."""
    names: Set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        args = node.args
        for a in args.args + args.posonlyargs + args.kwonlyargs:
            ann = getattr(a, "annotation", None)
            if a.arg == "self" or (isinstance(ann, ast.Name) and ann.id in HOST_ANNOTATIONS):
                continue
            names.add(a.arg)
        for extra in (args.vararg, args.kwarg):
            if extra is not None:
                names.add(extra.arg)
    return names


def _has_generator(node: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in node.keywords)


def _check_body(root: ast.AST, rel_path: str, findings: List[Finding]) -> None:
    tensor_params = _tensor_params(root)
    where = f"step body of `{root.name}`"

    def add(rule: str, line: int, what: str, advice: str) -> None:
        findings.append(Finding(rule, "error", rel_path, line, f"{what} in the {where} — {advice}"))

    for stmt in root.body:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func) or ()
            name = call_name(node)
            if len(chain) >= 2 and chain[0] in ("np", "numpy") and chain[1] == "random":
                add("JIT101", node.lineno, f"host RNG `{'.'.join(chain)}(...)`", "draw from the step's torch.Generator")
            elif len(chain) == 2 and chain[0] == "random" and chain[1] in STDLIB_RANDOM_FNS:
                add("JIT101", node.lineno, f"host RNG `random.{chain[1]}(...)`", "draw from the step's torch.Generator")
            elif (
                (chain[:1] == ("torch",) and len(chain) == 2 and name in TORCH_RANDOM_FNS)
                or (isinstance(node.func, ast.Attribute) and name in TENSOR_RANDOM_METHODS)
            ) and not _has_generator(node):
                add("JIT101", node.lineno, f"`{'.'.join(chain) or name}(...)` without `generator=`",
                    "it draws from the global stream; pass the step's torch.Generator")
            elif len(chain) == 2 and chain[0] == "time" and chain[1] in CLOCK_FNS:
                add("JIT102", node.lineno, f"wall clock `time.{chain[1]}()`", "measure around the dispatch instead")
            elif chain[-2:] == ("cuda", "synchronize"):
                add("JIT103", node.lineno, "`torch.cuda.synchronize()`", "a blocking host sync on the hot path")
            elif isinstance(node.func, ast.Attribute) and name in SYNC_METHODS and not node.args:
                add("JIT103", node.lineno, f"`.{name}()`", "a blocking device->host sync on the hot path")
            elif name == "print" and isinstance(node.func, ast.Name):
                add("JIT104", node.lineno, "bare `print`", "host I/O on every step")
            elif (
                isinstance(node.func, ast.Name)
                and node.func.id in ("float", "int", "bool")
                and len(node.args) == 1
                and isinstance(node.args[0], ast.Name)
                and node.args[0].id in tensor_params
            ):
                add("JIT105", node.lineno, f"`{node.func.id}({node.args[0].id})` on a tensor argument",
                    "a silent host sync")


def run(index: RepoIndex) -> List[Finding]:
    findings: List[Finding] = []
    for path, tree in index.modules(PACKAGE_PREFIX):
        source = index.py_source(path) or ""
        if "instrument" not in source and not any(prefix in source for prefix in BUILDER_PREFIXES):
            continue  # no step body: nothing passed to instrument(), no builder
        for root in _traced_roots(tree):
            _check_body(root, path, findings)
    # a nested def is walked inside its parent AND as its own closure member
    # when referenced by name — keep one finding per site
    unique: List[Finding] = []
    seen = set()
    for finding in findings:
        key = (finding.rule, finding.file, finding.line, finding.message)
        if key not in seen:
            seen.add(key)
            unique.append(finding)
    return unique
