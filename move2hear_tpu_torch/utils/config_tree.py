"""A minimal yacs-style config tree (nested attribute access, YAML merge,
dotted-key CLI overrides, freeze/clone) and a reader for the YAML subset
the repo's configs use, so the port needs no YAML package.

The subset: nested block mappings by indentation, ``# comments``, flow
lists ``[a, "b", 1]`` and scalars. Plain scalars resolve as PyYAML's
``safe_load`` resolves them (YAML 1.1 booleans, decimal ints, floats that
need a dot, nulls); quoted scalars are strings.
"""

from __future__ import annotations

import copy
import re
from typing import Any, Iterable, List

_BOOL = re.compile(
    r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$"
)
_TRUE = {"yes", "true", "on"}
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
)


def _plain_scalar(s: str) -> Any:
    if _BOOL.match(s):
        return s.lower() in _TRUE
    if _NULL.match(s):
        return None
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        t = s.replace("_", "").lower()
        if t.endswith("inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith("nan"):
            return float("nan")
        return float(t)
    return s


def _quoted(s: str) -> str:
    body = s[1:-1]
    if s[0] == "'":
        return body.replace("''", "'")
    return (body.replace("\\\\", "\x00").replace('\\"', '"')
            .replace("\\n", "\n").replace("\\t", "\t").replace("\x00", "\\"))


def _split_flow(body: str) -> List[str]:
    items, cur, quote, depth = [], [], None, 0
    for ch in body:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
            cur.append(ch)
        elif ch == "[":
            depth += 1
            cur.append(ch)
        elif ch == "]":
            depth -= 1
            cur.append(ch)
        elif ch == "," and depth == 0:
            items.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    last = "".join(cur).strip()
    if last or items:
        items.append(last)
    return [i for i in items if i != ""]


def parse_scalar(s: str) -> Any:
    """One YAML value: a flow list, a quoted string or a plain scalar."""
    s = s.strip()
    if s.startswith("[") and s.endswith("]"):
        return [parse_scalar(i) for i in _split_flow(s[1:-1])]
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "\"'":
        return _quoted(s)
    return _plain_scalar(s)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def load_yaml(text: str) -> dict:
    """Parse the repo's YAML subset; an empty document gives {}."""
    root: dict = {}
    stack = [(-1, root)]
    opened = []  # (parent, key, child) for "key:" lines, to null empty ones
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        key, sep, rest = line.strip().partition(":")
        if not sep or (rest and not rest.startswith((" ", "\t"))):
            raise ValueError(f"line {lineno}: unsupported YAML: {raw!r}")
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        key = parse_scalar(key)
        rest = rest.strip()
        if rest:
            parent[key] = parse_scalar(rest)
        else:
            child: dict = {}
            parent[key] = child
            stack.append((indent, child))
            opened.append((parent, key, child))
    for parent, key, child in reversed(opened):
        if not child:
            parent[key] = None
    return root


class Config(dict):
    """dict with attribute access, recursive merge and freeze semantics."""

    def __init__(self, init: dict | None = None):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        if init:
            for k, v in init.items():
                self[k] = Config(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any):
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"Config is frozen; cannot set {name}")
        self[name] = Config(value) if isinstance(value, dict) else value

    def __setitem__(self, key, value):
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"Config is frozen; cannot set {key}")
        super().__setitem__(key, value)

    def clone(self) -> "Config":
        c = Config()
        for k, v in self.items():
            c[k] = v.clone() if isinstance(v, Config) else copy.deepcopy(v)
        return c

    def freeze(self):
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, Config):
                v.freeze()
        return self

    def defrost(self):
        object.__setattr__(self, "_frozen", False)
        for v in self.values():
            if isinstance(v, Config):
                v.defrost()
        return self

    def merge_from_other(self, other: dict):
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), Config):
                self[k].merge_from_other(v)
            else:
                self[k] = Config(v) if isinstance(v, dict) else v
        return self

    def merge_from_file(self, path: str):
        with open(path) as f:
            return self.merge_from_other(load_yaml(f.read()))

    def merge_from_list(self, opts: Iterable[Any]):
        """['RL.PPO.lr_pol', 1e-4, 'SEED', 3] dotted override pairs."""
        opts = list(opts)
        if len(opts) % 2:
            raise ValueError(f"odd number of override elements: {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = str(key).split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if isinstance(value, str):
                value = _coerce(value, node.get(leaf))
            node[leaf] = value
        return self

    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, Config) else copy.deepcopy(v))
            for k, v in self.items()
        }


def _coerce(value: str, old: Any):
    """String -> python value for CLI overrides, typed like the old value."""
    try:
        parsed = parse_scalar(value)
    except ValueError:
        parsed = value
    if isinstance(old, bool) and not isinstance(parsed, bool):
        return bool(parsed)
    if isinstance(old, float) and isinstance(parsed, int) and not isinstance(parsed, bool):
        return float(parsed)
    return parsed
