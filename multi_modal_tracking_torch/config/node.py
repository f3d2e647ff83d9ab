"""Attribute-access config tree with strict YAML overlay.

The port's own copy of the JAX package's config tree (same semantics, same
experiment files): `update_from_file` overlays an experiment YAML onto the
default tree and raises on any key that does not already exist.
"""
from __future__ import annotations

from typing import Any, Dict

import yaml


class CfgNode(dict):
    """dict with attribute access; nested dicts are converted recursively."""

    def __init__(self, d: Dict[str, Any] | None = None):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = CfgNode(value) if isinstance(value, dict) and not isinstance(value, CfgNode) else value

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for k, v in self.items():
            if isinstance(v, CfgNode):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [x.to_dict() if isinstance(x, CfgNode) else
                          (list(x) if isinstance(x, list) else x) for x in v]
            else:
                out[k] = v
        return out

    def merge_strict(self, other: Dict[str, Any], path: str = ""):
        """Overlay `other`; raise on keys absent from the default tree."""
        for k, v in other.items():
            if k not in self:
                raise ValueError(f"{path + k} not exist in default config")
            if isinstance(v, dict):
                node = self[k]
                if not isinstance(node, CfgNode):
                    raise ValueError(f"{path + k}: cannot merge dict into leaf")
                node.merge_strict(v, path + k + ".")
            else:
                self[k] = v

    def update_from_file(self, filename: str):
        with open(filename) as f:
            exp = yaml.safe_load(f) or {}
        self.merge_strict(exp)

