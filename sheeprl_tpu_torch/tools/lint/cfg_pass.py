"""CFG — the YAML config tree and the ``cfg.*`` accesses that consume it.

``dotdict.__getattr__`` is ``dict.get``: a typo'd ``cfg.algo.leraning_rate``
silently evaluates to ``None`` and trains garbage instead of raising.  And
PyYAML speaks YAML 1.1, where a plain ``off`` parses as ``False`` — the exact
coercion that bit ``diagnostics.transfers``.  This pass cross-references
three harvests, all static:

1. **defined keys** — every leaf under ``sheeprl_tpu_torch/configs/**/*.yaml``,
   flattened to dotted paths honoring ``# @package`` headers (``_global_`` =
   root, default = the group directory) and defaults-list package mounts
   (``- /optim@optimizer: adam`` inside an ``algo`` file mounts every
   ``optim`` option's keys at ``algo.optimizer.*``);
2. **accessed keys** — every ``cfg.<path>`` attribute chain in the python
   tree, plus ``.get("key")`` / ``["key"]`` extensions, chains rooted at
   local aliases (``diag_cfg = cfg.get("diagnostics")``), ``self.cfg`` /
   ``self._cfg`` attributes, and ``${a.b}`` interpolations inside the YAML
   values themselves;
3. **runtime-added keys** — ``cfg.<path> = ...`` stores, which both define
   the stored path and exempt its subtree from typo reports.

A *maximal* access (``instantiate(cfg.algo.optimizer)``) consumes its whole
subtree — past that point the consumer is opaque to static analysis, so keys
under it are never reported dead.  Conversely ``.get("k")`` accesses are
deliberate optional reads: they mark keys live but are exempt from the typo
rule (absence is handled by the default).

Rules:

* **CFG201** (error) — attribute/subscript access to a key no config file
  defines (typo: silently evaluates to None);
* **CFG202** (warning) — defined leaf key no code path reads (dead config);
* **CFG203** (error) — a plain YAML-1.1 bool string (``on``/``off``/``yes``
  /``no``) in a config file: PyYAML loads it as a bool, not the string the
  author sees.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

import yaml

from sheeprl_tpu_torch.tools.lint import Finding
from sheeprl_tpu_torch.tools.lint.loader import RepoIndex

CONFIGS_PREFIX = "sheeprl_tpu_torch/configs/"
PACKAGE_RE = re.compile(r"#\s*@package\s+(\S+)")
INTERP_RE = re.compile(r"\$\{([A-Za-z0-9_.]+)\}")
# YAML-1.1 spellings that are bools to PyYAML but read as strings to humans;
# True/False/true/false are excluded — those are intended bools
YAML11_BOOLS = {"on", "On", "ON", "off", "Off", "OFF", "yes", "Yes", "YES", "no", "No", "NO"}
# framework keys consumed by the composer / instantiate, not by cfg accesses
SPECIAL_KEYS = {"_target_", "_partial_", "_convert_", "_recursive_", "_self_", "defaults"}
# attribute reads that are dict/dotdict METHODS, not config keys
DICT_METHODS = {
    "get",
    "keys",
    "values",
    "items",
    "pop",
    "setdefault",
    "update",
    "copy",
    "clear",
    "as_dict",
}

Path = Tuple[str, ...]

RULES = {
    "CFG201": "cfg access to a key no config file defines (typo -> silent None)",
    "CFG202": "config key defined but never read by any code path (dead config)",
    "CFG203": "unquoted YAML-1.1 bool string (on/off/yes/no) in a config file",
}


# -- YAML harvest ----------------------------------------------------------
class YamlHarvest:
    def __init__(self) -> None:
        #: every defined path (leaves AND intermediate mappings) -> first (file, line)
        self.defined: Dict[Path, Tuple[str, int]] = {}
        #: paths whose YAML value is a mapping (attribute access continues below them)
        self.mappings: Set[Path] = set()
        #: leaf paths (scalar/sequence values) -> every (file, line) definition
        self.leaves: Dict[Path, List[Tuple[str, int]]] = {}
        #: paths referenced by ${...} interpolations in config values
        self.interp_refs: Set[Path] = set()
        self.findings: List[Finding] = []
        #: group name -> list of mount paths its options are relocated to
        self._mounts: List[Tuple[str, Path]] = []
        #: groups referenced in a defaults list WITHOUT an @-relocation
        self._plain_groups: set = set()
        #: file -> (group, package, package-relative flattened entries)
        self._per_file: Dict[str, Tuple[str, Path, List[Tuple[Path, bool, int]]]] = {}

    def _define(self, path: Path, file: str, line: int, is_mapping: bool) -> None:
        for i in range(1, len(path) + 1):
            self.defined.setdefault(path[:i], (file, line))
        if is_mapping:
            self.mappings.add(path)
        else:
            self.leaves.setdefault(path, []).append((file, line))

    def scan_file(self, index: RepoIndex, rel: str) -> None:
        source = index.yaml_source(rel) or ""
        node = index.yaml_node(rel)
        group = rel[len(CONFIGS_PREFIX) :].rsplit("/", 1)
        group_dir = group[0] if len(group) == 2 else ""
        package: Optional[Path] = None
        for line in source.splitlines()[:5]:
            match = PACKAGE_RE.search(line)
            if match:
                package = () if match.group(1) == "_global_" else tuple(match.group(1).split("."))
                break
        if package is None:
            package = tuple(p for p in group_dir.split("/") if p)
        entries: List[Tuple[Path, bool, int]] = []
        if isinstance(node, yaml.MappingNode):
            self._walk(node, (), rel, entries, top=True, package=package)
        self._per_file[rel] = (group_dir, package, entries)
        # ${...} interpolations are absolute key references
        for match in INTERP_RE.finditer(source):
            ref = match.group(1)
            if ":" in ref:  # resolver call like ${now:%fmt}
                continue
            self.interp_refs.add(tuple(ref.split(".")))

    def _walk(
        self,
        node: yaml.MappingNode,
        prefix: Path,
        rel: str,
        entries: List[Tuple[Path, bool, int]],
        top: bool,
        package: Path,
    ) -> None:
        for key_node, value_node in node.value:
            self._check_bool(key_node, rel)
            key = str(key_node.value)
            if top and key == "defaults":
                self._scan_defaults(value_node, rel, package)
                continue
            path = prefix + tuple(key.split("."))
            if isinstance(value_node, yaml.MappingNode):
                entries.append((path, True, key_node.start_mark.line + 1))
                self._walk(value_node, path, rel, entries, top=False, package=package)
            else:
                entries.append((path, False, key_node.start_mark.line + 1))
                for scalar in self._iter_scalars(value_node):
                    self._check_bool(scalar, rel)

    def _iter_scalars(self, node: yaml.Node):
        if isinstance(node, yaml.ScalarNode):
            yield node
        elif isinstance(node, yaml.SequenceNode):
            for child in node.value:
                yield from self._iter_scalars(child)

    def _check_bool(self, node: yaml.Node, rel: str) -> None:
        if (
            isinstance(node, yaml.ScalarNode)
            and node.style is None  # plain (unquoted) scalar
            and node.value in YAML11_BOOLS
        ):
            self.findings.append(
                Finding(
                    "CFG203",
                    "error",
                    rel,
                    node.start_mark.line + 1,
                    f"plain `{node.value}` is a BOOL to YAML 1.1 (PyYAML) — quote it "
                    f'("{node.value}") if a string is meant, or spell the bool '
                    "True/False (the diagnostics.transfers off->False bug)",
                )
            )

    def _scan_defaults(self, node: yaml.Node, rel: str, package: Path) -> None:
        if not isinstance(node, yaml.SequenceNode):
            return
        for entry in node.value:
            if not isinstance(entry, yaml.MappingNode) or not entry.value:
                continue
            key_node = entry.value[0][0]
            key = str(key_node.value)
            if "@" not in key:
                group_part = key.replace("override ", "").strip().lstrip("/")
                if group_part and group_part != "_self_":
                    self._plain_groups.add(group_part)
                continue
            group_part, target = key.split("@", 1)
            group_part = group_part.replace("override ", "").strip().lstrip("/")
            mount = package + tuple(target.split("."))
            self._mounts.append((group_part, mount))

    def finalize(self) -> None:
        """Materialize definitions.  A *mount-only* group (``optim``,
        ``logger``: only ever pulled in via ``/group@target``) defines keys
        exclusively at its mount points — its bare package would otherwise
        read as one dead subtree per option file."""
        mount_sources = {group for group, _ in self._mounts}
        for rel, (file_group, package, entries) in self._per_file.items():
            mount_only = file_group in mount_sources and file_group not in self._plain_groups
            if mount_only:
                continue
            for i in range(1, len(package) + 1):
                self.defined.setdefault(package[:i], (rel, 1))
                self.mappings.add(package[:i])
            for path, is_mapping, line in entries:
                self._define(package + path, rel, line, is_mapping)
        for group, mount in self._mounts:
            for rel, (file_group, _package, entries) in self._per_file.items():
                if file_group != group:
                    continue
                for path, is_mapping, line in entries:
                    self._define(mount + path, rel, line, is_mapping)
            # the mount point itself is a mapping
            for i in range(1, len(mount) + 1):
                self.defined.setdefault(mount[:i], ("(mount)", 1))
            self.mappings.add(mount)


# -- python harvest --------------------------------------------------------
class PyHarvest:
    """Per-module resolution of cfg-rooted access chains."""

    CFG_ROOTS = ("cfg",)
    SELF_CFG_ATTRS = ("cfg", "_cfg")

    def __init__(self) -> None:
        #: every resolved access: (path, file, line, via_get, scope)
        #: scope identifies the enclosing function — the root-typo rule only
        #: judges accesses in functions that also touch a known top-level
        #: group (evidence their `cfg` is the FULL config, not a subsection)
        self.accesses: List[Tuple[Path, str, int, bool, Tuple[str, int]]] = []
        #: maximal (non-extended) access paths: wholesale subtree consumption
        self.maximal: Set[Path] = set()
        #: paths stored to at runtime (cfg.x.y = ...)
        self.stored: Set[Path] = set()

    def scan_module(self, tree: ast.Module, rel: str) -> None:
        #: alias name -> (path, resolved_via_get): `diag_cfg = cfg.get("x")`
        #: is an optional read (typo-exempt), `algo_cfg = cfg.algo` is NOT —
        #: a typo through a plain-attribute alias must still be caught
        aliases: Dict[str, Tuple[Path, bool]] = {}
        extended: Set[int] = set()

        def resolve(node: ast.AST, record_ext: bool = True) -> Optional[Tuple[Path, bool]]:
            if isinstance(node, ast.Name):
                if node.id in self.CFG_ROOTS:
                    return (), False
                if node.id in aliases:
                    return aliases[node.id]
            elif isinstance(node, ast.Attribute):
                if isinstance(node.value, ast.Name) and node.value.id == "self":
                    if node.attr in self.SELF_CFG_ATTRS:
                        return (), False
                    return None
                if node.attr in DICT_METHODS:
                    # `cfg.algo.get(...)` — a dict METHOD, not the key "get";
                    # the Call handler resolves the .get() read itself
                    return None
                base = resolve(node.value)
                if base is not None:
                    if record_ext:
                        extended.add(id(node.value))
                    return base[0] + (node.attr,), base[1]
            elif isinstance(node, ast.Subscript):
                key = node.slice
                if isinstance(key, ast.Constant) and isinstance(key.value, str):
                    base = resolve(node.value)
                    if base is not None:
                        if record_ext:
                            extended.add(id(node.value))
                        return base[0] + tuple(key.value.split(".")), base[1]
            elif isinstance(node, ast.Call):
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "get"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                ):
                    base = resolve(node.func.value)
                    if base is not None:
                        if record_ext:
                            extended.add(id(node.func.value))
                        return base[0] + (node.args[0].value,), True
            elif isinstance(node, ast.BoolOp) and isinstance(node.op, ast.Or) and node.values:
                return resolve(node.values[0])
            return None

        # alias fixpoint: `diag_cfg = (cfg or {}).get("diagnostics") or {}`
        assigns = [n for n in ast.walk(tree) if isinstance(n, ast.Assign)]
        for _ in range(3):
            changed = False
            for assign in assigns:
                if len(assign.targets) == 1 and isinstance(assign.targets[0], ast.Name):
                    resolved = resolve(assign.value, record_ext=False)
                    name = assign.targets[0].id
                    if resolved is not None and resolved[0] and aliases.get(name) != resolved:
                        aliases[name] = resolved
                        changed = True
            if not changed:
                break

        # enclosing-function intervals for scope attribution
        fn_spans = sorted(
            (
                (node.lineno, node.end_lineno or node.lineno)
                for node in ast.walk(tree)
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            ),
            key=lambda span: span[0] - span[1],
        )

        def scope_of(lineno: int) -> Tuple[str, int]:
            # OUTERMOST enclosing function (largest interval first): nested
            # defs read `cfg` from the enclosing closure, so evidence that the
            # top-level function holds the full config covers them
            for start, end in fn_spans:
                if start <= lineno <= end:
                    return (rel, start)
            return (rel, 0)

        resolutions: List[Tuple[ast.AST, Path, bool]] = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
                resolved = resolve(node)
                if resolved is not None and resolved[0]:
                    resolutions.append((node, resolved[0], resolved[1]))
        for node, path, via_get in resolutions:
            self.accesses.append((path, rel, node.lineno, via_get, scope_of(node.lineno)))
            if id(node) not in extended:
                self.maximal.add(path)
        # runtime-added keys: cfg.<path> = ... / cfg["<k>"] = ...
        for assign in assigns:
            for target in assign.targets:
                if isinstance(target, (ast.Attribute, ast.Subscript)):
                    resolved = resolve(target, record_ext=False)
                    if resolved is not None and resolved[0]:
                        self.stored.add(resolved[0])


def run(index: RepoIndex) -> List[Finding]:
    yaml_h = YamlHarvest()
    for rel in index.yaml_paths(CONFIGS_PREFIX):
        if index.yaml_node(rel) is not None:
            yaml_h.scan_file(index, rel)
    yaml_h.finalize()

    py_h = PyHarvest()
    for rel, tree in index.modules():
        py_h.scan_module(tree, rel)

    findings = list(yaml_h.findings)
    accessed: Set[Path] = {p for p, _, _, _, _ in py_h.accesses} | yaml_h.interp_refs
    stored_prefixes = py_h.stored

    def under_stored(path: Path) -> bool:
        return any(path[: len(s)] == s for s in stored_prefixes)

    # scopes whose cfg demonstrably IS the full composed config: at least one
    # access lands on a defined top-level group.  Only those scopes are judged
    # for root-segment typos — a helper whose `cfg` parameter is a subsection
    # (cfg.algo handed down) must not have every access flagged.
    top_level_defined = {p for p in yaml_h.defined if len(p) == 1}
    full_cfg_scopes = {
        scope for path, _, _, _, scope in py_h.accesses if (path[0],) in top_level_defined
    }

    # CFG201: strict (non-get) accesses to keys nothing defines.  The typo is
    # reported at the SHORTEST undefined prefix, so misspelled middle (and,
    # with scope evidence, root) segments are caught, not just leaves.
    seen: Set[Tuple[Path, str, int]] = set()
    for path, rel, line, via_get, scope in py_h.accesses:
        if via_get or len(path) < 2:
            continue
        if path in yaml_h.defined or under_stored(path):
            continue
        depth = 0
        while depth < len(path) and path[: depth + 1] in yaml_h.defined:
            depth += 1
        if depth == len(path):
            continue
        bad = path[: depth + 1]
        parent = bad[:-1]
        if depth == 0:
            # unknown ROOT segment: only a typo when this scope provably
            # holds the full config, and the access goes deeper than one hop
            if scope not in full_cfg_scopes:
                continue
        elif parent not in yaml_h.mappings:
            # defined parent that is a scalar leaf: attr reads on the VALUE
            # (string/list methods), not a config key lookup
            continue
        if under_stored(bad):
            continue
        key = (bad, rel, line)
        if key in seen:
            continue
        seen.add(key)
        closest = "`" + ".".join(parent) + "`" if parent else "the config root"
        findings.append(
            Finding(
                "CFG201",
                "error",
                rel,
                line,
                f"`cfg.{'.'.join(bad)}` is not defined by any config file — dotdict "
                f"returns None silently (typo? closest defined parent is {closest})",
            )
        )

    # CFG202: defined leaves nothing reads
    def consumed(path: Path) -> bool:
        if path in accessed or path in yaml_h.interp_refs:
            return True
        # wholesale: some strict ancestor was consumed as a maximal expression
        for i in range(1, len(path)):
            if path[:i] in py_h.maximal or path[:i] in yaml_h.interp_refs:
                return True
        return False

    for path, sites in sorted(yaml_h.leaves.items()):
        if path[-1] in SPECIAL_KEYS or any(seg in SPECIAL_KEYS for seg in path):
            continue
        if consumed(path) or under_stored(path):
            continue
        file, line = sites[0]
        findings.append(
            Finding(
                "CFG202",
                "warning",
                file,
                line,
                f"config key `{'.'.join(path)}` is defined but never read by any "
                "code path (dead config, or consumed through an access pattern "
                "the lint cannot see — fix or baseline with a why)",
            )
        )
    return findings
