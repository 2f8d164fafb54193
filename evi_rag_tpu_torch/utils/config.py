"""Composable YAML config system with groups, experiment overlays, overrides.

Replaces the reference's Hydra 1.3 surface (``configs/`` with ~80 YAML files,
``configs/train.yaml:1-50``) with a small deterministic resolver:

* a config file may declare ``defaults: [{group: name}, ...]``; each entry
  loads ``<configs_dir>/<group>/<name>.yaml`` into the ``group`` key (or
  merges into the root for ``_self_``-style inline dicts);
* ``experiment=<name>`` loads ``experiment/<name>.yaml`` as an overlay merged
  *after* the base -- the reference's experiment-alias pattern;
* CLI overrides use dotted paths (``model.hidden_dim=512``,
  ``dataset=webqsp-sub``); group overrides (bare ``group=name``) swap the
  whole group file before overlays, like Hydra's group syntax;
* ``${env:VAR,default}`` interpolation covers the reference's
  ``${oc.env:RETRIEVER_CKPT,null}`` usage.

Values parse as YAML scalars (so ``lr=3e-4`` and ``k=[1,10]`` work).
"""

from __future__ import annotations

import copy
import os
import pathlib
import re
from typing import Any

import yaml

_ENV_RE = re.compile(r"\$\{env:([A-Za-z_][A-Za-z0-9_]*)(?:,([^}]*))?\}")


class ConfigError(ValueError):
    pass


def _interp_env(value: Any) -> Any:
    if isinstance(value, str):
        m = _ENV_RE.fullmatch(value.strip())
        if m:
            var, default = m.group(1), m.group(2)
            raw = os.environ.get(var)
            if raw is None:
                if default is None:
                    raise ConfigError(f"environment variable {var} is required")
                raw = default
            return yaml.safe_load(raw) if raw != "" else ""
        return _ENV_RE.sub(lambda m: os.environ.get(m.group(1), m.group(2) or ""), value)
    if isinstance(value, dict):
        return {k: _interp_env(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_interp_env(v) for v in value]
    return value


def deep_merge(base: dict, overlay: dict) -> dict:
    """Recursive dict merge; overlay wins; lists replace wholesale."""
    out = copy.deepcopy(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def set_dotted(cfg: dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        nxt = node.get(k)
        if not isinstance(nxt, dict):
            nxt = {}
            node[k] = nxt
        node = nxt
    node[keys[-1]] = value


def get_dotted(cfg: dict, dotted: str, default: Any = None) -> Any:
    node: Any = cfg
    for k in dotted.split("."):
        if not isinstance(node, dict) or k not in node:
            return default
        node = node[k]
    return node


def _load_yaml(path: pathlib.Path) -> dict:
    if not path.exists():
        raise ConfigError(f"config file not found: {path}")
    data = yaml.safe_load(path.read_text())
    if data is None:
        return {}
    if not isinstance(data, dict):
        raise ConfigError(f"config root must be a mapping: {path}")
    return data


def _load_group(configs_dir: pathlib.Path, group: str, name: str) -> dict:
    return _load_yaml(configs_dir / group / f"{name}.yaml")


def load_config(
    configs_dir: str | pathlib.Path,
    config_name: str,
    overrides: list[str] | None = None,
) -> dict:
    """Resolve a full config: base -> groups -> experiment overlay -> overrides."""
    configs_dir = pathlib.Path(configs_dir)
    base = _load_yaml(configs_dir / f"{config_name}.yaml")
    defaults = base.pop("defaults", [])

    # Split overrides into group swaps, experiment selection, value overrides.
    group_swaps: dict[str, str] = {}
    experiment: str | None = None
    value_overrides: list[tuple[str, Any]] = []
    for ov in overrides or []:
        if "=" not in ov:
            raise ConfigError(f"override must be key=value, got {ov!r}")
        key, raw = ov.split("=", 1)
        value = yaml.safe_load(raw) if raw != "" else ""
        if key == "experiment":
            experiment = str(value)
        elif "." not in key and (configs_dir / key).is_dir():
            group_swaps[key] = str(value)
        else:
            value_overrides.append((key, value))

    cfg: dict = {}
    for entry in defaults:
        if isinstance(entry, str):
            if entry == "_self_":
                cfg = deep_merge(cfg, base)
                continue
            raise ConfigError(f"string default {entry!r} not supported (use _self_)")
        if not isinstance(entry, dict) or len(entry) != 1:
            raise ConfigError(f"invalid defaults entry: {entry!r}")
        (group, name), = entry.items()
        if name is None:
            continue
        name = group_swaps.pop(group, name)
        cfg[group] = deep_merge(cfg.get(group, {}), _load_group(configs_dir, group, str(name)))
    if "_self_" not in [e for e in defaults if isinstance(e, str)]:
        cfg = deep_merge(cfg, base)

    # Remaining group swaps (groups not in defaults).
    for group, name in group_swaps.items():
        cfg[group] = deep_merge(cfg.get(group, {}), _load_group(configs_dir, group, name))

    if experiment is not None:
        overlay = _load_yaml(configs_dir / "experiment" / f"{experiment}.yaml")
        overlay.pop("defaults", None)
        # Experiment may itself swap groups via `<group>: <name>` strings.
        for group in list(overlay.keys()):
            val = overlay[group]
            if isinstance(val, str) and (configs_dir / group).is_dir():
                cfg[group] = deep_merge(cfg.get(group, {}), _load_group(configs_dir, group, val))
                overlay.pop(group)
        cfg = deep_merge(cfg, overlay)
        cfg["experiment_name"] = experiment

    for key, value in value_overrides:
        set_dotted(cfg, key, value)

    return _interp_env(cfg)
