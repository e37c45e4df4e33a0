"""Environment-interpolating YAML config loader (port of
``transfusion_tpu/config/loader.py``; PyYAML is imported by
:func:`load_config` only, so the rest of the port runs without it).

Drop-in functional equivalent of the reference's EnvYAML wrapper
(``runner/utils/envyaml_wrapper.py:4-19``): the reference run configs
(``runner/nao/configs/ego_nao_res50_ego4d*.yml``) must load unmodified,
including ``${CODE}``/``${DATA}``/``${RUNS}`` interpolation inside string
values and nested config-file references.
"""

from __future__ import annotations

import os
import re
from typing import Any

_ENV_PATTERN = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)\}|\$([A-Za-z_][A-Za-z0-9_]*)")


def expand_env(value: str, env: dict[str, str] | None = None) -> str:
    """Expand ``${VAR}`` / ``$VAR`` references in a string.

    Unset variables expand to the empty string, matching EnvYAML's strict=False
    behavior the reference relies on for optional roots.
    """
    src = os.environ if env is None else env

    def sub(m: re.Match) -> str:
        name = m.group(1) or m.group(2)
        return str(src.get(name, ""))

    return _ENV_PATTERN.sub(sub, value)


def _expand_tree(node: Any, env: dict[str, str] | None) -> Any:
    if isinstance(node, str):
        return expand_env(node, env)
    if isinstance(node, dict):
        return {k: _expand_tree(v, env) for k, v in node.items()}
    if isinstance(node, list):
        return [_expand_tree(v, env) for v in node]
    return node


class Config(dict):
    """A plain dict with the small extra surface the reference code uses.

    ``config.set(k, v)`` and ``config.yaml_config`` mirror
    ``runner/utils/envyaml_wrapper.py:13-19`` so the runner code translates
    one-to-one.
    """

    def set(self, key: str, value: Any) -> None:
        self[key] = value

    @property
    def yaml_config(self) -> dict:
        return dict(self)

    @classmethod
    def from_tree(cls, tree: dict) -> "Config":
        cfg = cls()
        cfg.update(tree)
        return cfg


def load_config(path: str | os.PathLike, env: dict[str, str] | None = None) -> Config:
    """Load a YAML file with environment interpolation applied to all strings."""
    import yaml

    with open(os.fspath(path), "r") as fp:
        raw = yaml.safe_load(fp)
    if raw is None:
        raw = {}
    if not isinstance(raw, dict):
        raise ValueError(f"top-level YAML in {path!s} must be a mapping, got {type(raw)}")
    return Config.from_tree(_expand_tree(raw, env))
