"""LCK — lock discipline & thread-safety for the concurrent runtime.

The framework is genuinely multi-threaded (serving HTTP handlers, the
batcher dispatcher, checkpoint watchers, the stall watchdog, the async
checkpoint writer, the request-log writer), and its concurrency invariants
used to live only in prose.  This pass builds a **per-module thread model**
and machine-checks the three disciplines the repo hand-maintains:

1. **Thread model** — thread entry points are ``threading.Thread(target=...)``
   / ``threading.Timer(..., fn)`` targets, ``run()`` of ``threading.Thread``
   subclasses, ``do_*`` handlers of ``BaseHTTPRequestHandler`` subclasses
   (``ThreadingHTTPServer`` runs each request on its own thread), and bound
   methods escaped as callbacks into constructors (``DynamicBatcher(
   self._dispatch, on_request_done=self._on_request_done)`` — a Capitalized
   callee, or a ``target=`` / ``callback=`` / ``on_*=`` keyword).  A
   name-based call graph *within the module* (``self.m()`` resolves to the
   same class; ``x.m()`` to any same-module method named ``m``; ``f()`` to a
   module or nested function) propagates each entry's context to everything
   it transitively calls.  Functions no entry reaches are main-path code,
   and main-path reachability is itself closed over the call graph.

2. **Shared-attribute guarding** — an instance attribute is *shared* when
   some context writes it and a different context (main counts as one)
   reads or writes it.  ``__init__`` assignments are safe publication and do
   not count.  Writes include subscript stores (``self.info[k] = v``) and
   mutating container calls (``.append``/``.add``/``.update``/...).  Every
   shared access must be dominated by a ``with self._lock``-style guard on
   one lock object; a method whose *every* same-class call site sits inside
   ``with self.<L>`` inherits that guard (the ``_..._locked`` helper
   pattern).  Escaped **reads** of an otherwise-guarded scalar are accepted:
   CPython attribute loads are atomic under the GIL and the monitoring
   readers (``snapshot``/``/healthz``) tolerate one-interval staleness —
   the double-checked ``self._compiled.get()`` fast path stays legal.

3. **Hand-maintained rules** — journal writes from non-main threads go
   through ``RunJournal``'s locked API, never a raw ``._fp`` handle; no
   blocking call (``time.sleep``, ``os.fsync``, ``subprocess.*``,
   ``torch.cuda.synchronize()``) and no journal emission
   while holding a *contended* monitor lock (one a thread context also
   acquires) — the goodput stall/stall_end disk-order exception is
   baselined with its why; ``Event.wait`` needs a positive timeout and
   ``Condition.wait`` a ``while`` predicate loop.

Rules:

* **LCK501** (error) — attribute shared across thread contexts with no
  lock-guarded access anywhere (unguarded shared write);
* **LCK502** (error) — attribute is lock-guarded elsewhere but a write
  escapes the guard (or accesses are split across two different locks);
* **LCK503** (error) — ``RunJournal`` file I/O outside its write lock, or
  thread-reachable code bypassing the locked API via a foreign ``._fp``;
* **LCK504** (warning) — blocking call or journal emission while holding a
  contended monitor lock;
* **LCK505** (error) — ``Event.wait`` without a positive timeout, or
  ``Condition.wait`` outside a ``while`` predicate loop.

Messages carry no line numbers (line drift must not churn the baseline);
the finding's ``line`` field is display-only, like every other family.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from sheeprl_tpu_torch.tools.lint import Finding
from sheeprl_tpu_torch.tools.lint.loader import RepoIndex, keyword_value

RULES = {
    "LCK501": "attribute shared across thread contexts is never lock-guarded",
    "LCK502": "write to a lock-guarded shared attribute escapes the lock",
    "LCK503": "journal file I/O outside RunJournal's locked API",
    "LCK504": "blocking call or journal emission while holding a contended lock",
    "LCK505": "Event.wait without positive timeout / Condition.wait outside a predicate loop",
}

#: ``threading.X()`` constructors that make an attribute a lock (guard) object
LOCK_TYPES = {"Lock", "RLock", "Condition"}
#: sync primitives: internally thread-safe, exempt from shared-attr analysis
SYNC_TYPES = LOCK_TYPES | {
    "Event",
    "Semaphore",
    "BoundedSemaphore",
    "Barrier",
    "Queue",
    "SimpleQueue",
    "LifoQueue",
    "PriorityQueue",
    "local",
}
#: container-method calls that mutate the receiver (a write, not a read)
MUTATOR_METHODS = {
    "append",
    "appendleft",
    "add",
    "update",
    "setdefault",
    "pop",
    "popleft",
    "popitem",
    "clear",
    "extend",
    "extendleft",
    "remove",
    "discard",
    "insert",
}
#: call names that hand a bound method to another thread even without
#: ``threading.Thread`` (constructor callbacks); checked case-sensitively
CALLBACK_KEYWORDS = ("target", "callback")
BLOCKING_LAST = {"sleep", "fsync", "synchronize"}
MAIN = "main"


def _chain(node: ast.AST) -> Tuple[str, ...]:
    """Like ``attr_chain`` but transparent to subscripts/calls along the
    spine: ``self._window[p].append`` -> ("self", "_window", "append")."""
    parts: List[str] = []
    while True:
        if isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        else:
            break
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def _threading_ctor(node: ast.AST) -> Optional[str]:
    """``threading.Lock()`` / ``Condition()`` / ``queue.Queue()`` -> type
    name, else None."""
    if not isinstance(node, ast.Call):
        return None
    chain = _chain(node.func)
    if not chain:
        return None
    last = chain[-1]
    if last in SYNC_TYPES and (len(chain) == 1 or chain[0] in ("threading", "queue", "multiprocessing")):
        return last
    return None


class _FuncInfo:
    """One function/method (or nested def): its self-attribute access sets,
    outgoing calls, and the rule-relevant call sites — all annotated with the
    lock guards lexically held at that point."""

    def __init__(self, qualname: str, cls: Optional[str], node: ast.AST):
        self.qualname = qualname
        self.cls = cls  # class owning `self` in this body (closures inherit it)
        self.node = node
        # (attr, "r"|"w", frozenset(lock names), line)
        self.accesses: List[Tuple[str, str, frozenset, int]] = []
        # (callee descriptor, frozenset(lock names at the call site))
        self.calls: List[Tuple[Tuple[str, str], frozenset]] = []
        # (display name, frozenset(locks), line) — candidate LCK504 blocking calls
        self.blocking: List[Tuple[str, frozenset, int]] = []
        # (display name, frozenset(locks), line) — candidate LCK504 emissions
        self.emissions: List[Tuple[str, frozenset, int]] = []
        # (receiver chain, has timeout, nonpositive literal, in while, line)
        self.waits: List[Tuple[Tuple[str, ...], bool, bool, bool, int]] = []
        # Attribute nodes whose chain touches a `_fp` (LCK503), with ctx info
        self.fp_uses: List[Tuple[Tuple[str, ...], frozenset, int]] = []
        self.local_events: Set[str] = set()
        # thread entries spawned here: (target spec, label suffix)
        self.spawns: List[Tuple[str, ...]] = []
        #: guards added by caller-propagation (every call site under one lock)
        self.inherited_locks: frozenset = frozenset()


class _ClassInfo:
    def __init__(self, name: str):
        self.name = name
        self.bases: List[Tuple[str, ...]] = []
        self.methods: Dict[str, _FuncInfo] = {}
        self.lock_attrs: Set[str] = set()
        self.sync_attrs: Set[str] = set()
        self.event_attrs: Set[str] = set()
        self.cond_attrs: Set[str] = set()


class _ModuleModel:
    """Everything LCK needs about one module: classes, functions, the call
    graph, thread entries and the per-function context sets."""

    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.classes: Dict[str, _ClassInfo] = {}
        self.functions: Dict[str, _FuncInfo] = {}  # qualname -> info (all of them)
        self.module_funcs: Dict[str, _FuncInfo] = {}  # top-level name -> info
        self.methods_by_name: Dict[str, List[_FuncInfo]] = {}
        self.ctx: Dict[str, Set[str]] = {}  # qualname -> entry labels (+ MAIN)
        self._collect(tree)
        self._walk_all()
        self._propagate_contexts()
        self._propagate_caller_guards()

    # -- structure collection ----------------------------------------------
    def _collect(self, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                info = _ClassInfo(node.name)
                info.bases = [c for b in node.bases if (c := _chain(b))]
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        finfo = _FuncInfo(f"{node.name}.{item.name}", node.name, item)
                        info.methods[item.name] = finfo
                        self.functions[finfo.qualname] = finfo
                        self.methods_by_name.setdefault(item.name, []).append(finfo)
                # sync-primitive attributes, wherever they are assigned
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Assign):
                        ctor = _threading_ctor(sub.value)
                        if ctor is None:
                            continue
                        for target in sub.targets:
                            chain = _chain(target)
                            if len(chain) == 2 and chain[0] == "self":
                                info.sync_attrs.add(chain[1])
                                if ctor in LOCK_TYPES:
                                    info.lock_attrs.add(chain[1])
                                if ctor == "Event":
                                    info.event_attrs.add(chain[1])
                                if ctor == "Condition":
                                    info.cond_attrs.add(chain[1])
                self.classes[node.name] = info
        for item in tree.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                finfo = _FuncInfo(item.name, None, item)
                self.module_funcs[item.name] = finfo
                self.functions[finfo.qualname] = finfo

    def _class_of(self, finfo: _FuncInfo) -> Optional[_ClassInfo]:
        return self.classes.get(finfo.cls) if finfo.cls else None

    # -- per-function body walk --------------------------------------------
    def _walk_all(self) -> None:
        for finfo in list(self.functions.values()):
            self._walk_function(finfo)

    def _walk_function(self, finfo: _FuncInfo) -> None:
        cls = self._class_of(finfo)
        nested: Dict[str, _FuncInfo] = {}

        def lock_name(expr: ast.AST) -> Optional[str]:
            chain = _chain(expr)
            if len(chain) == 2 and chain[0] == "self" and cls and chain[1] in cls.lock_attrs:
                return f"self.{chain[1]}"
            return None

        def record_write(target: ast.AST, locks: frozenset, line: int) -> None:
            chain = _chain(target)
            if len(chain) >= 2 and chain[0] == "self":
                kind = "w" if len(chain) == 2 else "r"  # self.x.y = v only reads x
                finfo.accesses.append((chain[1], kind, locks, line))

        def visit(node: ast.AST, locks: frozenset, in_while: bool) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a closure does NOT run under the lock its definition site
                # holds — fresh guard stack, same `self` binding
                child = _FuncInfo(f"{finfo.qualname}.<locals>.{node.name}", finfo.cls, node)
                nested[node.name] = child
                self.functions[child.qualname] = child
                self._walk_function(child)
                # defining a closure counts as a call edge only when invoked;
                # bare-name calls below resolve through `nested`
                return
            if isinstance(node, ast.ClassDef):
                return  # nested classes are collected at module scope
            if isinstance(node, ast.With):
                names = [n for item in node.items if (n := lock_name(item.context_expr))]
                inner = locks | frozenset(names)
                for item in node.items:
                    visit(item.context_expr, locks, in_while)
                for stmt in node.body:
                    visit(stmt, inner, in_while)
                return
            if isinstance(node, ast.While):
                visit(node.test, locks, in_while)
                for stmt in node.body + node.orelse:
                    visit(stmt, locks, True)
                return
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for target in targets:
                    record_write(target, locks, node.lineno)
                if isinstance(node, ast.Assign) and _threading_ctor(node.value) == "Event":
                    for target in node.targets:
                        if isinstance(target, ast.Name):
                            finfo.local_events.add(target.id)
                visit(node.value, locks, in_while)
                # subscript/attr spines inside targets still read their roots
                for target in targets:
                    for sub in ast.iter_child_nodes(target):
                        visit(sub, locks, in_while)
                return
            if isinstance(node, ast.Call):
                self._record_call(finfo, cls, nested, node, locks, in_while)
                for child in ast.iter_child_nodes(node):
                    visit(child, locks, in_while)
                return
            if isinstance(node, ast.Attribute):
                chain = _chain(node)
                if "_fp" in chain:
                    finfo.fp_uses.append((chain, locks, node.lineno))
                if len(chain) >= 2 and chain[0] == "self":
                    finfo.accesses.append((chain[1], "r", locks, node.lineno))
                    return  # the chain is recorded once, not per-segment
                for child in ast.iter_child_nodes(node):
                    visit(child, locks, in_while)
                return
            for child in ast.iter_child_nodes(node):
                visit(child, locks, in_while)

        body = getattr(finfo.node, "body", [])
        for stmt in body:
            visit(stmt, frozenset(), False)

    def _record_call(
        self,
        finfo: _FuncInfo,
        cls: Optional[_ClassInfo],
        nested: Dict[str, _FuncInfo],
        node: ast.Call,
        locks: frozenset,
        in_while: bool,
    ) -> None:
        chain = _chain(node.func)
        last = chain[-1] if chain else ""
        # -- call-graph edge ------------------------------------------------
        if chain:
            if len(chain) == 2 and chain[0] == "self" and cls and last in cls.methods:
                finfo.calls.append((("self", last), locks))
            elif len(chain) == 1:
                if last in nested:
                    finfo.calls.append((("qual", nested[last].qualname), locks))
                elif last in self.module_funcs:
                    finfo.calls.append((("bare", last), locks))
                elif last in self.classes and "__init__" in self.classes[last].methods:
                    finfo.calls.append((("qual", f"{last}.__init__"), locks))
            elif last in self.methods_by_name or last in self.module_funcs:
                finfo.calls.append((("name", last), locks))
        # -- thread spawns / escaped callbacks ------------------------------
        if last in ("Thread", "Timer") and (len(chain) == 1 or chain[0] == "threading"):
            target = keyword_value(node, "target")
            if target is None and last == "Timer" and len(node.args) >= 2:
                target = node.args[1]
            if target is not None:
                self._note_spawn(finfo, cls, nested, target)
        elif last and (last[0].isupper() or last in CALLBACK_KEYWORDS):
            for arg in node.args:
                self._note_spawn(finfo, cls, nested, arg, constructor_only=True)
            for kw in node.keywords:
                if kw.arg is not None:
                    self._note_spawn(finfo, cls, nested, kw.value, constructor_only=True)
        else:
            for kw in node.keywords:
                if kw.arg and (kw.arg in CALLBACK_KEYWORDS or kw.arg.startswith("on_")):
                    self._note_spawn(finfo, cls, nested, kw.value, constructor_only=True)
        # -- LCK504 candidates ---------------------------------------------
        if locks:
            if last in BLOCKING_LAST or (chain and chain[0] == "subprocess"):
                if not (last == "fsync" and _arg_rooted_at_self(node)):
                    self.blocking_note(finfo, ".".join(chain), locks, node.lineno)
            if _is_emission(chain):
                kind = None
                if node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
                    kind = node.args[0].value
                label = ".".join(chain) + (f"({kind!r})" if kind else "")
                finfo.emissions.append((label, locks, node.lineno))
        # -- LCK505 candidates ---------------------------------------------
        if last == "wait" and len(chain) >= 2:
            has_timeout = bool(node.args) or keyword_value(node, "timeout") is not None
            nonpositive = False
            arg = node.args[0] if node.args else keyword_value(node, "timeout")
            if isinstance(arg, ast.Constant) and isinstance(arg.value, (int, float)):
                nonpositive = arg.value <= 0
            finfo.waits.append((chain[:-1], has_timeout, nonpositive, in_while, node.lineno))

    def blocking_note(self, finfo: _FuncInfo, name: str, locks: frozenset, line: int) -> None:
        finfo.blocking.append((name, locks, line))

    def _note_spawn(
        self,
        finfo: _FuncInfo,
        cls: Optional[_ClassInfo],
        nested: Dict[str, _FuncInfo],
        value: ast.AST,
        constructor_only: bool = False,
    ) -> None:
        """``value`` escapes to another execution context: if it names a
        method/function of this module, register a thread entry for it."""
        chain = _chain(value)
        if not chain:
            return
        if len(chain) == 2 and chain[0] == "self" and cls and chain[1] in cls.methods:
            self._entries.add(cls.methods[chain[1]].qualname)
        elif len(chain) == 1 and not constructor_only:
            name = chain[0]
            if name in nested:
                self._entries.add(nested[name].qualname)
            elif name in self.module_funcs:
                self._entries.add(name)

    # -- contexts -----------------------------------------------------------
    def _resolve(self, desc: Tuple[str, str], caller: _FuncInfo) -> List[_FuncInfo]:
        kind, name = desc
        if kind == "self":
            cls = self._class_of(caller)
            return [cls.methods[name]] if cls and name in cls.methods else []
        if kind == "qual":
            info = self.functions.get(name)
            return [info] if info else []
        if kind == "bare":
            info = self.module_funcs.get(name)
            return [info] if info else []
        # name-based: every same-module method (or function) with that name
        targets = list(self.methods_by_name.get(name, []))
        if name in self.module_funcs:
            targets.append(self.module_funcs[name])
        return targets

    def _propagate_contexts(self) -> None:
        # structural entries: Thread-subclass run(), HTTP do_* handlers
        for cls in self.classes.values():
            base_lasts = {b[-1] for b in cls.bases}
            if "Thread" in base_lasts and "run" in cls.methods:
                self._entries.add(cls.methods["run"].qualname)
            if any("HTTPRequestHandler" in b or b == "BaseHTTPRequestHandler" for b in base_lasts):
                for mname, minfo in cls.methods.items():
                    if mname.startswith("do_"):
                        self._entries.add(minfo.qualname)
        ctx: Dict[str, Set[str]] = {q: set() for q in self.functions}
        for entry in self._entries:
            if entry in ctx:
                ctx[entry].add(f"{self.path}::{entry}")
        self._close_over_calls(ctx)
        # main-path roots: everything no entry reaches (public API called
        # cross-module, CLI entry points, __init__) — then close again so helpers
        # called from both a thread and main carry both contexts
        for qual, labels in ctx.items():
            if not labels:
                labels.add(MAIN)
        self._close_over_calls(ctx)
        self.ctx = ctx

    def _close_over_calls(self, ctx: Dict[str, Set[str]]) -> None:
        changed = True
        while changed:
            changed = False
            for qual, finfo in self.functions.items():
                labels = ctx[qual]
                if not labels:
                    continue
                for desc, _locks in finfo.calls:
                    for target in self._resolve(desc, finfo):
                        tl = ctx[target.qualname]
                        if not labels <= tl:
                            tl |= labels
                            changed = True

    # -- caller-guard propagation ------------------------------------------
    def _propagate_caller_guards(self) -> None:
        """A method whose every same-class call site sits inside ``with
        self.<L>`` (and that nothing else in the module calls by name) is a
        ``_..._locked``-style helper: treat its body as guarded by L."""
        for cls in self.classes.values():
            for mname, minfo in cls.methods.items():
                sites: List[frozenset] = []
                foreign = False
                for other in self.functions.values():
                    for desc, locks in other.calls:
                        kind, name = desc
                        if name != mname and not (kind == "qual" and name.endswith("." + mname)):
                            continue
                        if kind == "self" and other.cls == cls.name:
                            sites.append(locks)
                        elif kind in ("name", "bare", "qual"):
                            foreign = True  # could be another object: no propagation
                if sites and not foreign:
                    common = frozenset.intersection(*sites)
                    if common:
                        minfo.inherited_locks = common

    _entries: Set[str]

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj._entries = set()
        return obj

    # -- derived views -------------------------------------------------------
    def contended_locks(self, cls: _ClassInfo) -> Set[str]:
        """Lock attrs of ``cls`` acquired from at least one thread context —
        the 'monitor locks' LCK504 cares about (a lock only ever taken on
        the main path cannot stall another thread)."""
        out: Set[str] = set()
        for minfo in self._class_funcs(cls):
            if any(label != MAIN for label in self.ctx.get(minfo.qualname, ())):
                for _attr, _kind, locks, _line in minfo.accesses:
                    out |= set(locks)
                for _desc, locks in minfo.calls:
                    out |= set(locks)
                for _name, locks, _line in minfo.emissions + minfo.blocking:
                    out |= set(locks)
                out |= set(minfo.inherited_locks)
        return {lock for lock in out if lock.split(".", 1)[-1] in cls.lock_attrs}

    def _class_funcs(self, cls: _ClassInfo) -> List[_FuncInfo]:
        """Methods of ``cls`` plus closures defined inside them (which share
        the same ``self``)."""
        return [f for f in self.functions.values() if f.cls == cls.name]


def _arg_rooted_at_self(node: ast.Call) -> bool:
    """``os.fsync(self._fp.fileno())`` — fsyncing a self-owned handle is the
    leaf-lock pattern the journal documents, not a foreign blocking call."""
    if not node.args:
        return False
    arg = node.args[0]
    while isinstance(arg, ast.Call):
        arg = arg.func
    chain = _chain(arg)
    return bool(chain) and chain[0] == "self"


def _is_emission(chain: Tuple[str, ...]) -> bool:
    if not chain:
        return False
    last = chain[-1]
    if last in ("_journal", "_journal_fn", "_sync_fn"):
        return True
    if last in ("write", "sync") and len(chain) >= 2 and "journal" in chain[-2].lower():
        return True
    return False


def _ctx_names(labels: Sequence[str]) -> str:
    shown = sorted(label.split("::")[-1] if "::" in label else label for label in set(labels))
    return ", ".join(shown)


# -- the rules --------------------------------------------------------------
def _check_shared_attrs(model: _ModuleModel) -> List[Finding]:
    findings: List[Finding] = []
    for cls in model.classes.values():
        funcs = model._class_funcs(cls)
        # attr -> list of (kind, locks, line, ctx labels, func)
        per_attr: Dict[str, List[Tuple[str, frozenset, int, Set[str], _FuncInfo]]] = {}
        for finfo in funcs:
            if finfo.qualname.split(".")[-1] == "__init__" and finfo.cls == cls.name and "<locals>" not in finfo.qualname:
                continue  # safe publication
            labels = model.ctx.get(finfo.qualname, {MAIN})
            for attr, kind, locks, line in finfo.accesses:
                if attr in cls.sync_attrs:
                    continue
                effective = locks | finfo.inherited_locks
                per_attr.setdefault(attr, []).append((kind, effective, line, labels, finfo))
        for attr, accesses in sorted(per_attr.items()):
            writes = [a for a in accesses if a[0] == "w"]
            if not writes:
                continue
            write_ctx: Set[str] = set()
            for _kind, _locks, _line, labels, _f in writes:
                write_ctx |= labels
            if not any(label != MAIN for label in write_ctx):
                # only the main path ever writes: assign-before-thread-start
                # safe publication (facade.open(), monitor.open()) — a torn
                # read is impossible for a GIL-atomic attribute store
                continue
            all_ctx: Set[str] = set()
            for _kind, _locks, _line, labels, _f in accesses:
                all_ctx |= labels
            if len(all_ctx) < 2:
                continue  # single-context attribute: no race surface
            guarded = [a for a in accesses if a[1]]
            if not guarded:
                findings.append(
                    Finding(
                        "LCK501",
                        "error",
                        model.path,
                        writes[0][2],
                        f"shared attribute `{cls.name}.{attr}` (written from "
                        f"{_ctx_names(write_ctx)}; contexts touching it: "
                        f"{_ctx_names(all_ctx)}) is never lock-guarded — wrap every "
                        "access in one `with self.<lock>` block",
                    )
                )
                continue
            # accesses must agree on ONE lock; an access holding extra locks
            # (a _compile_lock caller taking _params_lock inside) still agrees
            common = frozenset.intersection(*[a[1] for a in guarded])
            if not common:
                locks_used = {lock for a in guarded for lock in a[1]}
                findings.append(
                    Finding(
                        "LCK502",
                        "error",
                        model.path,
                        guarded[0][2],
                        f"shared attribute `{cls.name}.{attr}` is guarded by "
                        f"different locks ({', '.join(f'`{lock}`' for lock in sorted(locks_used))}) "
                        "with no lock in common — accesses must agree on ONE "
                        "lock object to exclude each other",
                    )
                )
                continue
            guard = sorted(common)[0]
            seen_funcs: Set[str] = set()
            for kind, locks, line, _labels, finfo in writes:
                if locks or finfo.qualname in seen_funcs:
                    continue
                seen_funcs.add(finfo.qualname)
                findings.append(
                    Finding(
                        "LCK502",
                        "error",
                        model.path,
                        line,
                        f"write to `{cls.name}.{attr}` in `{finfo.qualname}` escapes "
                        f"the `{guard}` guard its other accesses hold (escaped reads "
                        "of a scalar are tolerated; escaped writes are a race)",
                    )
                )
    return findings


def _check_journal_api(model: _ModuleModel) -> List[Finding]:
    """LCK503 both ways: RunJournal's own file I/O must hold its lock, and
    thread-reachable code must never reach through a foreign ``._fp``."""
    findings: List[Finding] = []
    journal_cls = model.classes.get("RunJournal")
    if journal_cls is not None:
        for mname in ("write", "sync", "close"):
            minfo = journal_cls.methods.get(mname)
            if minfo is None:
                continue
            effective = minfo.inherited_locks
            for chain, locks, line in minfo.fp_uses:
                if chain[:2] == ("self", "_fp") and not (locks | effective):
                    findings.append(
                        Finding(
                            "LCK503",
                            "error",
                            model.path,
                            line,
                            f"RunJournal.{mname} touches the journal file handle "
                            "outside `with self._lock` — watchdog/HTTP threads "
                            "write this journal concurrently with the training "
                            "loop (a torn or interleaved record)",
                        )
                    )
                    break  # one finding per method keeps the key stable
            for name, locks, line in minfo.blocking:
                # os.fsync on a foreign handle etc. — self-rooted fsync was
                # already exempted at record time
                findings.append(
                    Finding("LCK503", "error", model.path, line,
                            f"RunJournal.{mname} blocks on `{name}` — keep only "
                            "the self-owned write/flush/fsync under the leaf lock")
                )
    for finfo in model.functions.values():
        labels = model.ctx.get(finfo.qualname, set())
        if not any(label != MAIN for label in labels):
            continue
        if finfo.cls == "RunJournal":
            continue
        for chain, _locks, line in finfo.fp_uses:
            if chain[:2] == ("self", "_fp") and len(chain) == 2:
                continue  # its own file handle (not a RunJournal)
            if chain[0] == "self" and len(chain) >= 2 and chain[1] == "_fp":
                continue
            findings.append(
                Finding(
                    "LCK503",
                    "error",
                    model.path,
                    line,
                    f"`{finfo.qualname}` (thread-reachable) reaches through "
                    f"`{'.'.join(chain)}` — journal writes from non-main threads "
                    "must go through RunJournal's locked write()/sync() API",
                )
            )
    return findings


def _check_lock_holding(model: _ModuleModel) -> List[Finding]:
    findings: List[Finding] = []
    for cls in model.classes.values():
        contended = model.contended_locks(cls)
        if not contended:
            continue
        for finfo in model._class_funcs(cls):
            for name, locks, line in finfo.blocking:
                held = (locks | finfo.inherited_locks) & contended
                if held:
                    findings.append(
                        Finding(
                            "LCK504",
                            "warning",
                            model.path,
                            line,
                            f"blocking call `{name}` in `{finfo.qualname}` while "
                            f"holding contended `{sorted(held)[0]}` — every thread "
                            "contending on that lock stalls behind it",
                        )
                    )
            for name, locks, line in finfo.emissions:
                held = (locks | finfo.inherited_locks) & contended
                if held:
                    findings.append(
                        Finding(
                            "LCK504",
                            "warning",
                            model.path,
                            line,
                            f"journal emission `{name}` in `{finfo.qualname}` while "
                            f"holding contended `{sorted(held)[0]}` — journal "
                            "outside the monitor lock (fsync latency is unbounded), "
                            "or baseline the documented ordering exception",
                        )
                    )
    return findings


def _check_waits(model: _ModuleModel) -> List[Finding]:
    findings: List[Finding] = []
    for finfo in model.functions.values():
        cls = model.classes.get(finfo.cls) if finfo.cls else None
        for receiver, has_timeout, nonpositive, in_while, line in finfo.waits:
            is_event = is_cond = False
            if len(receiver) == 2 and receiver[0] == "self" and cls:
                is_event = receiver[1] in cls.event_attrs
                is_cond = receiver[1] in cls.cond_attrs
            elif len(receiver) == 1:
                is_event = receiver[0] in finfo.local_events
            if is_event and (not has_timeout or nonpositive):
                findings.append(
                    Finding(
                        "LCK505",
                        "error",
                        model.path,
                        line,
                        f"`{'.'.join(receiver)}.wait()` in `{finfo.qualname}` has no "
                        "positive timeout — a missed set() (or a crashed setter) "
                        "parks this thread forever; poll with a timeout",
                    )
                )
            elif is_cond and not in_while:
                findings.append(
                    Finding(
                        "LCK505",
                        "error",
                        model.path,
                        line,
                        f"`{'.'.join(receiver)}.wait()` in `{finfo.qualname}` is not "
                        "inside a `while` predicate loop — condition waits wake "
                        "spuriously; re-check the predicate on every wakeup",
                    )
                )
    return findings


def run(index: RepoIndex) -> List[Finding]:
    findings: List[Finding] = []
    for path, tree in index.modules():
        if not path.endswith(".py"):
            continue
        model = _ModuleModel(path, tree)
        findings.extend(_check_shared_attrs(model))
        findings.extend(_check_journal_api(model))
        findings.extend(_check_lock_holding(model))
        findings.extend(_check_waits(model))
    return findings
