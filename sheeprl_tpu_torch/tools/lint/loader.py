"""Shared parsed view of the port for the lint passes.

Everything is AST/node based — **no module of the repo is ever imported**,
so the lint cannot crash on import-time side effects and runs the same on a
machine without torch, jax or a card.  Three source classes are indexed:

* Python under ``sheeprl_tpu_torch/`` plus the card scripts at the repo's
  root (``chip_smoke.py``, ``chip_gumbel_split.py``) — parsed once with
  :mod:`ast` and shared by every pass;
* YAML under ``sheeprl_tpu_torch/configs/`` — kept as :func:`yaml.compose`
  node trees so every key/value carries its line number and quoting style
  (a plain ``off`` and a quoted ``"off"`` are different nodes, which is the
  whole point of the CFG YAML-bool rule);
* the ``howto/*.md`` docs, which document the event and metric vocabulary
  both packages share; the JRN pass reads them, nothing edits them.

Tests build synthetic indexes with :meth:`RepoIndex.from_sources` — the
passes only ever see this interface, so fixtures are inline strings, not
files planted in the repo.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import yaml

#: directories (repo-relative, with trailing slash) scanned for python
PY_DIRS = ("sheeprl_tpu_torch/",)
#: repo-root scripts included in the python scan (cfg consumers)
PY_ROOT_FILES = ("chip_smoke.py", "chip_gumbel_split.py")
CONFIGS_DIR = "sheeprl_tpu_torch/configs/"
DOCS_DIR = "howto/"


class RepoIndex:
    """Parsed python/yaml/markdown sources, keyed by repo-relative path."""

    def __init__(
        self,
        root: Optional[Path],
        py_sources: Dict[str, str],
        yaml_sources: Dict[str, str],
        doc_sources: Dict[str, str],
    ):
        self.root = root
        self._py_sources = py_sources
        self._yaml_sources = yaml_sources
        self._doc_sources = doc_sources
        self._trees: Dict[str, ast.Module] = {}
        self._yaml_nodes: Dict[str, Optional[yaml.nodes.Node]] = {}
        #: (path, message) for files that would not parse — the entry point turns
        #: these into findings so a broken file fails loudly, not silently
        self.parse_errors: List[Tuple[str, str]] = []
        for path, src in sorted(py_sources.items()):
            try:
                self._trees[path] = ast.parse(src, filename=path)
            except SyntaxError as err:
                self.parse_errors.append((path, f"unparseable python: {err}"))
        for path, src in sorted(yaml_sources.items()):
            try:
                self._yaml_nodes[path] = yaml.compose(src, Loader=yaml.SafeLoader)
            except yaml.YAMLError as err:
                self._yaml_nodes[path] = None
                self.parse_errors.append((path, f"unparseable yaml: {err}"))

    # -- construction ------------------------------------------------------
    @classmethod
    def from_fs(cls, root: str | Path) -> "RepoIndex":
        root = Path(root)
        py: Dict[str, str] = {}
        yamls: Dict[str, str] = {}
        docs: Dict[str, str] = {}

        def _read(path: Path) -> str:
            return path.read_text(encoding="utf-8")

        for base in PY_DIRS:
            base_dir = root / base
            if not base_dir.is_dir():
                continue
            for path in sorted(base_dir.rglob("*.py")):
                if "__pycache__" in path.parts:
                    continue
                py[path.relative_to(root).as_posix()] = _read(path)
        for name in PY_ROOT_FILES:
            path = root / name
            if path.is_file():
                py[name] = _read(path)
        configs = root / CONFIGS_DIR
        if configs.is_dir():
            for path in sorted(configs.rglob("*.yaml")):
                yamls[path.relative_to(root).as_posix()] = _read(path)
        docs_dir = root / DOCS_DIR
        if docs_dir.is_dir():
            for path in sorted(docs_dir.glob("*.md")):
                docs[path.relative_to(root).as_posix()] = _read(path)
        return cls(root, py, yamls, docs)

    @classmethod
    def from_sources(cls, files: Dict[str, str]) -> "RepoIndex":
        """Build an index from inline ``{relpath: text}`` fixtures (tests)."""
        py = {p: s for p, s in files.items() if p.endswith(".py")}
        yamls = {p: s for p, s in files.items() if p.endswith((".yaml", ".yml"))}
        docs = {p: s for p, s in files.items() if p.endswith(".md")}
        return cls(None, py, yamls, docs)

    # -- python ------------------------------------------------------------
    def modules(self, prefix: str = "") -> Iterator[Tuple[str, ast.Module]]:
        for path in sorted(self._trees):
            if path.startswith(prefix):
                yield path, self._trees[path]

    def module(self, path: str) -> Optional[ast.Module]:
        return self._trees.get(path)

    def py_source(self, path: str) -> Optional[str]:
        return self._py_sources.get(path)

    # -- yaml --------------------------------------------------------------
    def yaml_paths(self, prefix: str = CONFIGS_DIR) -> List[str]:
        return [p for p in sorted(self._yaml_nodes) if p.startswith(prefix)]

    def yaml_node(self, path: str) -> Optional[yaml.nodes.Node]:
        return self._yaml_nodes.get(path)

    def yaml_source(self, path: str) -> Optional[str]:
        return self._yaml_sources.get(path)

    # -- docs --------------------------------------------------------------
    def docs(self) -> List[str]:
        return sorted(self._doc_sources)

    def doc(self, path: str) -> Optional[str]:
        return self._doc_sources.get(path)


# -- small AST helpers shared by the passes --------------------------------
def call_name(node: ast.Call) -> str:
    """Last path segment of the callee (``jax.jit`` -> ``jit``)."""
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def attr_chain(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """``np.random.normal`` -> ("np", "random", "normal"); None when the
    expression is not a pure Name/Attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def keyword_value(node: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None
