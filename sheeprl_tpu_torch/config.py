"""Hydra-compatible YAML config composition (counterpart of
``sheeprl_tpu/config.py``).

The subset of Hydra semantics the config tree uses:

- a root ``config.yaml`` with a ``defaults`` list of ``group: option`` entries;
- group config files, each optionally with its own ``defaults`` list supporting
  relative entries (``- default``), absolute entries with package relocation
  (``- /optim@optimizer: adam``) and ``- _self_`` ordering;
- ``# @package _global_`` experiment overlays with ``override /group: option``;
- CLI overrides: ``group=option`` to pick a group file, ``a.b.c=value`` for
  dotted value overrides (``+a.b=v`` also accepted);
- ``${a.b}`` absolute interpolation and the ``${now:%fmt}`` resolver;
- ``???`` mandatory-value markers (validated eagerly after composition).

Extra config directories (``extra_dirs``, and the ``:``-separated
``SHEEPRL_TPU_SEARCH_PATH``) are searched before the built-in tree, so a
user's own files add groups and options or shadow shipped ones; a
``_target_`` in such a file goes through :func:`own_targets`, as an archived
config's does.

:func:`instantiate` builds a ``_target_``; the targets in ``configs/`` that
name modules not ported yet are listed in ROADMAP.md.
"""

from __future__ import annotations

import datetime
import importlib
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import yaml

from sheeprl_tpu_torch.utils.utils import dotdict

CONFIG_DIR = Path(__file__).parent / "configs"
_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class _Yaml12Loader(yaml.SafeLoader):
    """SafeLoader with YAML-1.2 float semantics: PyYAML (YAML 1.1) parses
    ``1e-4`` as a *string* because it requires a dot before the exponent;
    the configs rely on it being a float (e.g. ``eps: 1e-04``)."""


_Yaml12Loader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def yaml_load(text: str) -> Any:
    return yaml.load(text, Loader=_Yaml12Loader)


class ConfigError(RuntimeError):
    pass


def _search_dirs(extra_dirs: Optional[Sequence[str]] = None) -> List[Path]:
    """``extra_dirs``, then ``SHEEPRL_TPU_SEARCH_PATH``'s directories, then
    the built-in tree (a path that is not a directory is skipped)."""
    env_paths = os.environ.get("SHEEPRL_TPU_SEARCH_PATH", "")
    dirs = [Path(p) for p in [*(extra_dirs or []), *(d for d in env_paths.split(":") if d)]]
    return [d for d in dirs if d.is_dir()] + [CONFIG_DIR]


def _find_config_file(group: str, option: str, dirs: Sequence[Path]) -> Path:
    option = option[:-5] if option.endswith(".yaml") else option
    for d in dirs:
        candidate = d / group / f"{option}.yaml"
        if candidate.is_file():
            return candidate
    raise ConfigError(f"Config '{group}/{option}.yaml' not found in {[str(d) for d in dirs]}")


def _load_yaml(path: Path) -> Tuple[Dict[str, Any], bool]:
    """Load a YAML file. Returns (content, is_global_package); the
    ``_target_``s of a file outside the built-in tree name the port's
    modules (:func:`own_targets`)."""
    text = path.read_text()
    is_global = False
    for line in text.splitlines():
        stripped = line.strip()
        if stripped.startswith("# @package"):
            is_global = "_global_" in stripped
            break
        if stripped and not stripped.startswith("#"):
            break
    data = yaml_load(text) or {}
    if not isinstance(data, dict):
        raise ConfigError(f"Top-level YAML in {path} must be a mapping")
    if CONFIG_DIR.resolve() not in path.resolve().parents:
        data = own_targets(data)
    return data, is_global


def deep_merge(base: Dict[str, Any], overlay: Mapping[str, Any]) -> Dict[str, Any]:
    """Merge ``overlay`` into ``base`` (dicts merge recursively, rest replaces)."""
    for k, v in overlay.items():
        if isinstance(v, Mapping) and isinstance(base.get(k), dict):
            deep_merge(base[k], v)
        else:
            base[k] = v.copy() if isinstance(v, dict) else (list(v) if isinstance(v, list) else v)
    return base


def _compose_group_file(group: str, option: str, dirs: Sequence[Path]) -> Dict[str, Any]:
    """Load a group option, recursively resolving its own defaults list."""
    path = _find_config_file(group, option, dirs)
    data, _ = _load_yaml(path)
    defaults = data.pop("defaults", None)
    if defaults is None:
        return data
    result: Dict[str, Any] = {}
    self_merged = False
    for entry in defaults:
        if entry == "_self_":
            deep_merge(result, data)
            self_merged = True
        elif isinstance(entry, str):
            deep_merge(result, _compose_group_file(group, entry, dirs))
        elif isinstance(entry, dict):
            for key, value in entry.items():
                key = str(key)
                if key.startswith("override"):
                    raise ConfigError(f"'override' not valid inside group file {path}")
                pkg = None
                src = key
                if "@" in key:
                    src, pkg = key.split("@", 1)
                src = src.lstrip("/")
                sub = _compose_group_file(src, str(value), dirs)
                if pkg is None or pkg in ("_here_", "_global_"):
                    deep_merge(result, sub)
                else:
                    node = result
                    for part in pkg.split("."):
                        node = node.setdefault(part, {})
                    deep_merge(node, sub)
        else:
            raise ConfigError(f"Unsupported defaults entry {entry!r} in {path}")
    if not self_merged:
        deep_merge(result, data)
    return result


def _parse_overrides(overrides: Sequence[str], dirs: Sequence[Path]) -> Tuple[Dict[str, str], Dict[str, Any]]:
    """Split CLI overrides into group selections and dotted value overrides."""
    group_sel: Dict[str, str] = {}
    dotted: Dict[str, Any] = {}
    for ov in overrides:
        if "=" not in ov:
            raise ConfigError(f"Override '{ov}' is not of the form key=value")
        key, _, value = ov.partition("=")
        key = key.lstrip("+~")
        parsed = yaml_load(value) if value != "" else None
        if "." not in key and any((d / key).is_dir() for d in dirs):
            group_sel[key] = str(value)
        else:
            dotted[key] = parsed
    return group_sel, dotted


def _set_dotted(cfg: Dict[str, Any], key: str, value: Any) -> None:
    node = cfg
    parts = key.split(".")
    for part in parts[:-1]:
        nxt = node.get(part)
        if not isinstance(nxt, dict):
            nxt = {}
            node[part] = nxt
        node = nxt
    node[parts[-1]] = value


def _get_dotted(cfg: Mapping[str, Any], key: str) -> Any:
    node: Any = cfg
    for part in key.split("."):
        if not isinstance(node, Mapping) or part not in node:
            raise KeyError(key)
        node = node[part]
    return node


def _resolve_value(value: Any, root: Mapping[str, Any], depth: int = 0) -> Any:
    if depth > 20:
        raise ConfigError(f"Interpolation loop while resolving {value!r}")
    if not isinstance(value, str):
        return value
    matches = list(_INTERP_RE.finditer(value))
    if not matches:
        return value

    def repl(expr: str) -> Any:
        if expr.startswith("now:"):
            return datetime.datetime.now().strftime(expr[4:])
        if expr.startswith("oc.env:") or expr.startswith("env:"):
            parts = expr.split(":", 1)[1].split(",", 1)
            return os.environ.get(parts[0], parts[1] if len(parts) > 1 else "")
        if expr.startswith("eval:"):
            raise ConfigError("eval resolver not supported")
        return _resolve_value(_get_dotted(root, expr), root, depth + 1)

    if len(matches) == 1 and matches[0].span() == (0, len(value)):
        try:
            return repl(matches[0].group(1))
        except KeyError:
            return value
    out = value
    for m in matches:
        try:
            out = out.replace(m.group(0), str(repl(m.group(1))))
        except KeyError:
            pass
    return out


def resolve_interpolations(cfg: Dict[str, Any], root: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    root = root if root is not None else cfg

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return _resolve_value(node, root)

    return walk(cfg)


def _missing_keys(cfg: Mapping[str, Any], prefix: str = "") -> List[str]:
    missing = []
    for k, v in cfg.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            missing.extend(_missing_keys(v, path + "."))
        elif isinstance(v, str) and v == "???":
            missing.append(path)
    return missing


def compose(overrides: Sequence[str] = (), extra_dirs: Optional[Sequence[str]] = None,
            check_missing: bool = True) -> dotdict:
    """Compose the full config tree the way ``@hydra.main`` does, from the
    root ``config.yaml`` found first in the search path
    (:func:`_search_dirs`); ``check_missing`` raises on a ``???`` left."""
    dirs = _search_dirs(extra_dirs)
    root_path = next(d / "config.yaml" for d in dirs if (d / "config.yaml").is_file())
    root_data, _ = _load_yaml(root_path)
    root_defaults = root_data.pop("defaults", [])

    group_sel, dotted = _parse_overrides(overrides, dirs)

    # Pass 1: figure out which option each group uses.
    selections: Dict[str, str] = {}
    order: List[str] = []
    self_first = True
    seen_self = False
    for entry in root_defaults:
        if entry == "_self_":
            seen_self = True
            continue
        if isinstance(entry, dict):
            for g, opt in entry.items():
                g = str(g)
                selections[g] = str(opt)
                order.append(g)
            if not seen_self:
                self_first = False
    selections.update(group_sel)
    for g in group_sel:
        if g not in order:
            order.append(g)

    # Experiment overlays are @package _global_ and may override group choices.
    # An exp file's defaults list may also include *sibling* exp files by bare
    # name (e.g. exp/ppo_recurrent.yaml starts from `- ppo`): those merge
    # first, recursively, each applying its own `override /group:` entries.
    exp_entries: List[Tuple[str, Dict[str, Any]]] = []

    def _collect_exp(option: str) -> None:
        path = _find_config_file("exp", option, dirs)
        data, _ = _load_yaml(path)
        for d_entry in data.get("defaults", []):
            if isinstance(d_entry, str):
                if d_entry != "_self_":
                    _collect_exp(d_entry)
            elif isinstance(d_entry, dict):
                for key, value in d_entry.items():
                    key = str(key)
                    if key.startswith("override"):
                        target = key.split("/", 1)[1].strip()
                        # CLI group selections beat the experiment file
                        if target not in group_sel:
                            selections[target] = str(value)
        exp_entries.append(("exp", data))

    for g in list(order):
        opt = selections.get(g, "???")
        if opt == "???":
            continue
        _, is_global = _load_yaml(_find_config_file(g, opt, dirs))
        if is_global and g == "exp":
            _collect_exp(opt)

    if selections.get("exp") == "???" and not exp_entries:
        if "exp" in order and "algo" in group_sel:
            selections.pop("exp", None)
            order.remove("exp")
        elif "exp" in order:
            raise ConfigError("You must specify an experiment: add exp=<name> (e.g. exp=dreamer_v3)")

    cfg: Dict[str, Any] = {}
    if self_first:
        deep_merge(cfg, root_data)
    for g in order:
        opt = selections.get(g)
        if opt is None or opt == "???" or g == "exp":
            continue  # exp merges last, at the global package
        deep_merge(cfg.setdefault(g, {}), _compose_group_file(g, opt, dirs))
    if not self_first:
        deep_merge(cfg, root_data)

    # Experiment overlay at _global_ package (minus its defaults list).
    for _, data in exp_entries:
        deep_merge(cfg, {k: v for k, v in data.items() if k != "defaults"})

    # Dotted CLI overrides win over everything.
    for key, value in dotted.items():
        _set_dotted(cfg, key, value)
    # `metric.logger=<option>` names an option of the logger group (the one
    # metric's defaults list takes as `/logger@logger`): compose it there
    # (the JAX package keeps the bare name, which its get_logger cannot build)
    logger = (cfg.get("metric") or {}).get("logger")
    if isinstance(logger, str) and any((d / "logger" / f"{logger}.yaml").is_file() for d in dirs):
        cfg["metric"]["logger"] = _compose_group_file("logger", logger, dirs)

    cfg = resolve_interpolations(cfg)
    if check_missing:
        missing = _missing_keys(cfg)
        if missing:
            raise ConfigError(f"Mandatory config values left unset (???): {missing}")
    return dotdict(cfg)


def compose_group(group: str, option: str = "default", extra_dirs: Optional[Sequence[str]] = None) -> dotdict:
    """Compose ONE group option outside a full run config (its own defaults
    list resolved, interpolations against itself; the search path as
    :func:`compose`'s).  The serve CLI uses this to backfill the ``serving``
    block of an archived run config."""
    sub = _compose_group_file(group, option, _search_dirs(extra_dirs))
    return dotdict(resolve_interpolations(sub))


#: ``_target_`` prefix of a config archived by the JAX package -> the port's
#: (the port mirrors its module paths), and the optax factories it has
_FOREIGN_PREFIX = ("sheeprl_tpu.", "sheeprl_tpu_torch.")
_FOREIGN_TARGETS = {"optax.adam": "sheeprl_tpu_torch.utils.optim.adam",
                    "optax.adamw": "sheeprl_tpu_torch.utils.optim.adamw",
                    "optax.rmsprop": "sheeprl_tpu_torch.utils.optim.rmsprop",
                    "optax.sgd": "sheeprl_tpu_torch.utils.optim.sgd"}


def own_targets(node: Any) -> Any:
    """A copy of an archived run config with every ``_target_`` the JAX
    package wrote (``sheeprl_tpu.…``, ``optax.adam``, ``optax.adamw``, ``optax.rmsprop``,
    ``optax.sgd``)
    naming the port's counterpart, so that a JAX run resumes and evaluates
    here."""
    if isinstance(node, Mapping):
        out = {k: own_targets(v) for k, v in node.items()}
        target = out.get("_target_")
        if isinstance(target, str):
            if target.startswith(_FOREIGN_PREFIX[0]):
                target = _FOREIGN_PREFIX[1] + target[len(_FOREIGN_PREFIX[0]):]
            out["_target_"] = _FOREIGN_TARGETS.get(target, target)
        return dotdict(out) if isinstance(node, dotdict) else out
    if isinstance(node, list):
        return [own_targets(v) for v in node]
    return node


def instantiate(node: Mapping[str, Any] | Any, **kwargs: Any) -> Any:
    """Recursive ``_target_`` instantiation (Hydra's
    ``hydra.utils.instantiate``, without ``_partial_``: no config of the
    port uses it).  The port imports no optax: a target in ``optax``
    raises, unless it is one the port has (:data:`_FOREIGN_TARGETS`)."""
    if not isinstance(node, Mapping) or "_target_" not in node:
        return node
    target = _FOREIGN_TARGETS.get(str(node["_target_"]), str(node["_target_"]))
    if target.split(".", 1)[0] == "optax":
        raise NotImplementedError(f"the optimizer {target} is not ported yet (see ROADMAP.md Queue 1)")
    module_name, _, attr = target.rpartition(".")
    obj = getattr(importlib.import_module(module_name), attr)

    def _inst(v: Any) -> Any:
        if isinstance(v, Mapping):
            return instantiate(v) if "_target_" in v else {kk: _inst(vv) for kk, vv in v.items()}
        if isinstance(v, list):
            return [_inst(item) for item in v]
        return v

    call_kwargs = {k: _inst(v) for k, v in node.items() if k != "_target_"}
    call_kwargs.update(kwargs)
    return obj(**call_kwargs)
