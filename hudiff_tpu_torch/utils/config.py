# Copied from hudiff_tpu/utils/config.py.
"""YAML config handling: attribute-style nested namespaces.

Replaces the reference's yaml + EasyDict pattern
(antibody_scripts/antibody_train.py:341-342). Configs serialize into
checkpoints and become the source of truth downstream, as in the reference.
``yaml`` is imported inside ``load_yaml`` only: a machine without PyYAML can
still import this module and build configs as literals.
"""
from __future__ import annotations

import json
from typing import Any, Mapping


class Namespace(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    @classmethod
    def wrap(cls, obj: Any) -> Any:
        if isinstance(obj, Mapping):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(cls.wrap(v) for v in obj)
        return obj

    def to_dict(self) -> dict:
        def unwrap(o):
            if isinstance(o, Namespace):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, (list, tuple)):
                return type(o)(unwrap(v) for v in o)
            return o
        return unwrap(self)


def load_yaml(path: str) -> Namespace:
    import yaml
    with open(path) as f:
        return Namespace.wrap(yaml.safe_load(f))


def load_json(path: str) -> Namespace:
    with open(path) as f:
        return Namespace.wrap(json.load(f))


def dump_json(cfg: Namespace, path: str) -> None:
    with open(path, 'w') as f:
        json.dump(cfg.to_dict(), f, indent=2)
