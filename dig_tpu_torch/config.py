"""Configuration tree: a copy of ``dig_tpu/config.py`` (host-only).

One attribute-accessible tree with a YAML / JSON loader and dotted-path
overrides:

    cfg = Config.load("conf.yaml", overrides=["train.lr=1e-3"])
    cfg.train.lr

Any nested dict becomes attribute-accessible; model hyperparameters stay
typed constructor arguments of the modules.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


class Config(dict):
    """Attribute-accessible nested dict with YAML/JSON IO + overrides."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) and not isinstance(
            v, Config) else v

    def __setattr__(self, k, v):
        self[k] = v

    @classmethod
    def load(cls, path: str,
             overrides: Optional[List[str]] = None) -> "Config":
        with open(path) as f:
            text = f.read()
        if path.endswith(".json"):
            data = json.loads(text)
        else:
            data = _parse_yaml(text)
        cfg = cls(_deep(data))
        for ov in overrides or []:
            cfg.set_dotted(*ov.split("=", 1))
        return cfg

    @classmethod
    def from_dict(cls, data: Dict) -> "Config":
        return cls(_deep(data))

    def set_dotted(self, key: str, value: str):
        parts = key.split(".")
        node = self
        for p in parts[:-1]:
            node = node.setdefault(p, Config())
        node[parts[-1]] = _coerce(value)

    def to_dict(self) -> Dict:
        return {k: (v.to_dict() if isinstance(v, Config) else v)
                for k, v in self.items()}

    def save(self, path: str):
        with open(path, "w") as f:
            if path.endswith(".json"):
                json.dump(self.to_dict(), f, indent=2)
            else:
                f.write(_dump_yaml(self.to_dict()))


def _deep(d):
    if isinstance(d, dict):
        return Config({k: _deep(v) for k, v in d.items()})
    if isinstance(d, list):
        return [_deep(v) for v in d]
    return d


def _coerce(s: str) -> Any:
    t = s.strip()
    low = t.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none", "~"):
        return None
    for cast in (int, float):
        try:
            return cast(t)
        except ValueError:
            pass
    if t.startswith("[") and t.endswith("]"):
        inner = t[1:-1].strip()
        return [_coerce(x) for x in inner.split(",")] if inner else []
    return t.strip("'\"")


def _parse_yaml(text: str) -> Dict:
    """Minimal YAML subset: nested mappings by indentation, scalars,
    inline lists, comments (no yaml package needed)."""
    root: Dict = {}
    stack = [(-1, root)]
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip())
        key, _, val = line.strip().partition(":")
        while stack and indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if val.strip() == "":
            child: Dict = {}
            parent[key] = child
            stack.append((indent, child))
        else:
            parent[key] = _coerce(val)
    return root


def _dump_yaml(d: Dict, indent: int = 0) -> str:
    out = []
    pad = "  " * indent
    for k, v in d.items():
        if isinstance(v, dict):
            out.append(f"{pad}{k}:")
            out.append(_dump_yaml(v, indent + 1))
        else:
            out.append(f"{pad}{k}: {json.dumps(v) if isinstance(v, str) else v}")
    return "\n".join(out)
