"""Hierarchical config trees with composition and command-line overrides.

Counterpart of ``liteattention_tpu/training/config_tree.py``, with the same
public names and the same semantics: a root ``config.yaml`` whose
``defaults:`` list composes group files (``trainer/default.yaml``,
``optimizer/adamw.yaml``, ...), ``# @package _global_`` files that merge
at the root, ``${a.b}`` interpolation, and Hydra's override grammar
(``a.b=v``, ``+a.b=v``, ``~a.b``, ``group=name``, ``group=null``).

The JAX module reads YAML with PyYAML's ``safe_load``; the port carries its
own reader (:func:`parse_yaml`) so that it needs no YAML package. It reads
the YAML the config tree uses and gives what ``safe_load`` gives for it:

* block mappings and block sequences (``- key: value`` items, nested
  blocks, a sequence at its key's indentation);
* plain scalars resolved as YAML 1.1 does (null, booleans, decimal /
  hex / octal / binary ints, floats whose mantissa has a dot, ``.inf``,
  ``.nan``; ``1e-4`` stays a string, as in PyYAML), single- and
  double-quoted scalars, and flow sequences ``[a, 1, 'b']``;
* comments, blank lines and the ``# @package _global_`` header.

Anything else (flow mappings, anchors and aliases, tags, block scalars,
multi-line plain scalars, document markers, directives, timestamps,
sexagesimal numbers, tabs in indentation) raises :class:`YAMLError`.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "load_config",
    "compose",
    "apply_overrides",
    "merge_trees",
    "resolve_interpolations",
    "select",
    "to_flat_kwargs",
    "parse_yaml",
    "YAMLError",
]

_GLOBAL_PKG_RE = re.compile(r"^#\s*@package\s+_global_\s*$", re.MULTILINE)
_INTERP_RE = re.compile(r"\$\{([A-Za-z0-9_.]+)\}")


# ------------------------------------------------------------------ YAML


class YAMLError(ValueError):
    """YAML the reader does not take (or that is malformed)."""


# PyYAML's implicit resolvers (yaml/resolver.py) for the core types.
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False, "NO": False,
         "true": True, "True": True, "TRUE": True, "false": False, "False": False,
         "FALSE": False, "on": True, "On": True, "ON": True, "off": False, "Off": False,
         "OFF": False}
_INT_RE = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                     r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT_RE = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# Forms PyYAML resolves that the reader does not take.
_SEXAGESIMAL_RE = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_TIMESTAMP_RE = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_INDICATORS = "[]{}&*!|>%@`?"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}


def _resolve_plain(text: str, where: str) -> Any:
    """A plain scalar's value, as YAML 1.1 (PyYAML's safe_load) resolves it."""
    if _NULL_RE.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT_RE.match(text):
        s = text.replace("_", "")
        sign = -1 if s[0] == "-" else 1
        s = s.lstrip("+-")
        if s == "0":
            return 0
        if s.startswith("0b"):
            return sign * int(s[2:], 2)
        if s.startswith("0x"):
            return sign * int(s[2:], 16)
        if s.startswith("0"):
            return sign * int(s, 8)
        return sign * int(s)
    if _FLOAT_RE.match(text):
        s = text.replace("_", "").lower()
        if s.endswith(".inf"):
            return float("-inf") if s.startswith("-") else float("inf")
        if s.endswith(".nan"):
            return float("nan")
        return float(s)
    if _SEXAGESIMAL_RE.match(text) or _TIMESTAMP_RE.match(text):
        raise YAMLError(f"{where}: sexagesimal numbers and timestamps are not supported: {text!r}")
    if text[0] in _INDICATORS or text.startswith(("- ", ": ")) or text in ("-", ":"):
        raise YAMLError(f"{where}: unsupported YAML: {text!r}")
    if text.startswith("#"):
        raise YAMLError(f"{where}: a plain scalar cannot start with '#': {text!r}")
    return text


def _quoted(text: str, pos: int, where: str) -> Tuple[str, int]:
    """The quoted scalar starting at ``text[pos]``: (its value, the index
    just past the closing quote). One line only."""
    q = text[pos]
    out, i = [], pos + 1
    while i < len(text):
        c = text[i]
        if q == "'":
            if c == "'":
                if text[i + 1 : i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(c)
            i += 1
            continue
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            e = text[i + 1 : i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            n = {"x": 2, "u": 4, "U": 8}.get(e)
            code = text[i + 2 : i + 2 + (n or 0)]
            if n is None or len(code) != n or not all(h in "0123456789abcdefABCDEF" for h in code):
                raise YAMLError(f"{where}: unsupported escape in a double-quoted scalar")
            out.append(chr(int(code, 16)))
            i += 2 + n
            continue
        out.append(c)
        i += 1
    raise YAMLError(f"{where}: unterminated or multi-line quoted scalar")


def _flow_seq(text: str, pos: int, where: str) -> Tuple[list, int]:
    """The flow sequence starting at ``text[pos] == '['``: (its items, the
    index just past its ``]``). Items: quoted or plain scalars and nested
    flow sequences."""
    items, i = [], pos + 1
    while True:
        while i < len(text) and text[i] == " ":
            i += 1
        if i >= len(text):
            raise YAMLError(f"{where}: unterminated flow sequence")
        c = text[i]
        if c == "]":
            return items, i + 1
        if c == "[":
            item, i = _flow_seq(text, i, where)
        elif c in "'\"":
            item, i = _quoted(text, i, where)
        elif c in ",{":
            raise YAMLError(f"{where}: unsupported flow syntax {c!r}")
        else:
            j = i
            while j < len(text) and text[j] not in ",[]{}":
                j += 1
            raw = text[i:j].strip()
            if ": " in raw or raw.endswith(":"):
                raise YAMLError(f"{where}: mappings inside flow sequences are not supported")
            item, i = _resolve_plain(raw, where), j
        items.append(item)
        while i < len(text) and text[i] == " ":
            i += 1
        if text[i : i + 1] == ",":
            i += 1
        elif text[i : i + 1] != "]":
            raise YAMLError(f"{where}: expected ',' or ']' in a flow sequence")


def _value(text: str, where: str) -> Any:
    """An inline value (the part of a line after ``key:`` or ``- ``)."""
    if text[0] in "'\"":
        val, end = _quoted(text, 0, where)
    elif text[0] == "[":
        val, end = _flow_seq(text, 0, where)
    else:
        if ": " in text or text.endswith(":"):
            raise YAMLError(f"{where}: a mapping value is not allowed here: {text!r}")
        return _resolve_plain(text, where)
    if text[end:].strip():
        raise YAMLError(f"{where}: unexpected text after a scalar: {text[end:]!r}")
    return val


def _strip_comment(line: str) -> str:
    """``line`` without its comment: a ``#`` at the start or after a space,
    outside quotes (a quote opens a scalar only where one may start)."""
    quote, prev = None, None
    i = 0
    while i < len(line):
        c = line[i]
        if quote == "'":
            if c == "'":
                if line[i + 1 : i + 2] == "'":
                    i += 2
                    continue
                quote = None
        elif quote == '"':
            if c == "\\":
                i += 2
                continue
            if c == '"':
                quote = None
        elif c in "'\"" and (prev is None or prev in ":-[,"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        if c != " ":
            prev = c
        i += 1
    return line.rstrip()


def _key_split(content: str, where: str) -> Optional[Tuple[Any, str]]:
    """``(key, rest)`` of a ``key: rest`` line, or None if it is not one."""
    if content[0] in "'\"":
        key, end = _quoted(content, 0, where)
        if content[end : end + 1] != ":" or content[end + 1 : end + 2] not in ("", " "):
            return None
        return key, content[end + 1 :].strip()
    m = re.search(r":(?: |$)", content)
    if m is None:
        return None
    raw = content[: m.start()].rstrip()
    if not raw:
        raise YAMLError(f"{where}: empty key")
    if raw.startswith("? "):
        raise YAMLError(f"{where}: complex keys are not supported")
    return _resolve_plain(raw, where), content[m.end() :].strip()


class _Lines:
    def __init__(self, text: str, name: str):
        self.items: List[List] = []  # [indent, content, line number]
        for n, raw in enumerate(text.splitlines(), 1):
            where = f"{name}:{n}"
            body = raw.lstrip(" ")
            if body.startswith("\t"):
                raise YAMLError(f"{where}: tabs in indentation are not supported")
            content = _strip_comment(body)
            if not content:
                continue
            if content in ("---", "...") or content.startswith(("--- ", "%")):
                raise YAMLError(f"{where}: document markers and directives are not supported")
            self.items.append([len(raw) - len(body), content, n])
        self.name = name

    def where(self, i):
        return f"{self.name}:{self.items[i][2]}"


def _is_seq(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _block(lines: _Lines, i: int, indent: int) -> Tuple[Any, int]:
    """The block node whose first line is ``lines[i]`` at ``indent``:
    (value, index of the first line after it)."""
    content = lines.items[i][1]
    if _is_seq(content):
        return _sequence(lines, i, indent)
    if _key_split(content, lines.where(i)) is not None:
        return _mapping(lines, i, indent)
    value = _value(content, lines.where(i))
    if i + 1 < len(lines.items) and lines.items[i + 1][0] > indent:
        raise YAMLError(f"{lines.where(i + 1)}: multi-line scalars are not supported")
    return value, i + 1


def _nested(lines: _Lines, i: int, indent: int, key_line: int) -> Tuple[Any, int]:
    """The value of a ``key:`` or ``-`` with nothing after it on its line
    (``key_line``, at ``indent``): a more indented block, a sequence at the
    key's own indentation (mapping values only; ``i`` is then >= 0), or
    None."""
    if i < len(lines.items):
        ind, content, _ = lines.items[i]
        if ind > indent:
            return _block(lines, i, ind)
        if key_line >= 0 and ind == indent and _is_seq(content):
            return _sequence(lines, i, indent)
    return None, i


def _sequence(lines: _Lines, i: int, indent: int) -> Tuple[list, int]:
    out = []
    while i < len(lines.items) and lines.items[i][0] == indent:
        content = lines.items[i][1]
        if not _is_seq(content):
            break
        rest = content[1:].lstrip(" ")
        if not rest:
            val, i = _nested(lines, i + 1, indent, -1)
        else:
            # An item that starts a block on its own line: the block's
            # column is where the item's text starts.
            col = indent + len(content) - len(rest)
            lines.items[i] = [col, rest, lines.items[i][2]]
            val, i = _block(lines, i, col)
        out.append(val)
    if i < len(lines.items) and lines.items[i][0] > indent:
        raise YAMLError(f"{lines.where(i)}: bad indentation")
    return out, i


def _mapping(lines: _Lines, i: int, indent: int) -> Tuple[dict, int]:
    out: Dict[Any, Any] = {}
    while i < len(lines.items) and lines.items[i][0] == indent:
        content = lines.items[i][1]
        if _is_seq(content):
            if out:
                raise YAMLError(f"{lines.where(i)}: a sequence item inside a mapping")
            break
        split = _key_split(content, lines.where(i))
        if split is None:
            raise YAMLError(f"{lines.where(i)}: expected 'key: value', got {content!r}")
        key, rest = split
        if rest:
            out[key] = _value(rest, lines.where(i))
            i += 1
            if i < len(lines.items) and lines.items[i][0] > indent:
                raise YAMLError(f"{lines.where(i)}: multi-line scalars are not supported")
        else:
            out[key], i = _nested(lines, i + 1, indent, i)
    if i < len(lines.items) and lines.items[i][0] > indent:
        raise YAMLError(f"{lines.where(i)}: bad indentation")
    return out, i


def parse_yaml(text: str, name: str = "<yaml>") -> Any:
    """The YAML document ``text`` as ``yaml.safe_load`` reads it, for the
    subset this module supports (None for an empty document). ``name``
    labels the errors."""
    lines = _Lines(text, name)
    if not lines.items:
        return None
    value, i = _block(lines, 0, lines.items[0][0])
    if i != len(lines.items):
        raise YAMLError(f"{lines.where(i)}: bad indentation")
    return value


# ------------------------------------------------------------ the tree


def _load_yaml(path: str) -> Tuple[Dict[str, Any], bool]:
    """Load one YAML file; returns (tree, is_global_package)."""
    with open(path) as f:
        text = f.read()
    tree = parse_yaml(text, path) or {}
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: top level must be a mapping")
    return tree, bool(_GLOBAL_PKG_RE.search(text))


def merge_trees(dst: Dict[str, Any], src: Dict[str, Any]) -> Dict[str, Any]:
    """Deep-merge ``src`` into ``dst`` (src wins; dicts merge, all other
    values -- lists included -- replace, as OmegaConf.merge does)."""
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            merge_trees(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def _place(tree: Dict[str, Any], group: str, sub: Dict[str, Any], is_global: bool) -> None:
    if is_global:
        merge_trees(tree, sub)
        return
    node = tree
    parts = group.split("/")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
        if not isinstance(node, dict):
            raise ValueError(f"group path {group!r} collides with a leaf")
    leaf = parts[-1]
    if isinstance(node.get(leaf), dict):
        merge_trees(node[leaf], sub)
    else:
        node[leaf] = copy.deepcopy(sub)


def compose(path: str, group_overrides: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """Compose one config file: its ``defaults:`` list in order, its own
    body at ``_self_`` (appended last when absent, so the file's own keys
    win). Recursive: a composed group file may have ``defaults:`` of its
    own. ``group_overrides`` remap which file a group composes (the
    ``group=name`` override; ``None`` drops the group)."""
    group_overrides = group_overrides or {}
    config_dir = os.path.dirname(os.path.abspath(path))
    body, _ = _load_yaml(path)
    defaults = body.pop("defaults", None)
    if defaults is None:
        return body
    if not isinstance(defaults, list):
        raise ValueError(f"{path}: 'defaults' must be a list")
    if not any(d == "_self_" for d in defaults):
        defaults = list(defaults) + ["_self_"]

    tree: Dict[str, Any] = {}
    for entry in defaults:
        if entry == "_self_":
            merge_trees(tree, body)
            continue
        if isinstance(entry, str):
            if entry.startswith("override"):  # Hydra-internal entries
                continue
            raise ValueError(f"{path}: unsupported defaults entry {entry!r}")
        if not isinstance(entry, dict) or len(entry) != 1:
            raise ValueError(f"{path}: malformed defaults entry {entry!r}")
        (group, name), = entry.items()
        if group.startswith("override hydra") or group.startswith("hydra"):
            continue
        name = group_overrides.get(group, name)
        if name is None or name == "null":
            continue
        sub_path = os.path.join(config_dir, group, f"{name}.yaml")
        if not os.path.exists(sub_path):
            raise FileNotFoundError(
                f"{path}: defaults entry '{group}: {name}' -> missing {sub_path}")
        sub = compose(sub_path, group_overrides)
        _, sub_global = _load_yaml(sub_path)
        _place(tree, group, sub, sub_global)
    return tree


def select(tree: Dict[str, Any], dotted: str, default: Any = None) -> Any:
    """``select(cfg, "optimizer.lr")``: dotted-path lookup."""
    node: Any = tree
    for p in dotted.split("."):
        if not isinstance(node, dict) or p not in node:
            return default
        node = node[p]
    return node


def _set(tree: Dict[str, Any], dotted: str, value: Any, must_exist: bool) -> None:
    parts = dotted.split(".")
    node = tree
    for p in parts[:-1]:
        if p not in node:
            if must_exist:
                raise KeyError(f"override path {dotted!r}: {p!r} not in config "
                               "(prefix with '+' to add new keys)")
            node[p] = {}
        node = node[p]
        if not isinstance(node, dict):
            raise KeyError(f"override path {dotted!r} crosses leaf {p!r}")
    leaf = parts[-1]
    if must_exist and leaf not in node:
        raise KeyError(f"override {dotted!r}: key does not exist "
                       "(prefix with '+' to add new keys)")
    node[leaf] = value


def _delete(tree: Dict[str, Any], dotted: str) -> None:
    parts = dotted.split(".")
    node = tree
    for p in parts[:-1]:
        node = node.get(p)
        if not isinstance(node, dict):
            return
    node.pop(parts[-1], None)


def apply_overrides(tree: Dict[str, Any], overrides: Sequence[str]) -> Dict[str, Any]:
    """Apply a Hydra-style dotlist: ``a.b=v``, ``+a.b=v``, ``~a.b``."""
    for ov in overrides:
        if ov.startswith("~"):
            _delete(tree, ov[1:])
            continue
        add = ov.startswith("+")
        if add:
            ov = ov[1:]
        if "=" not in ov:
            raise ValueError(f"override {ov!r} is not key=value")
        key, _, raw = ov.partition("=")
        _set(tree, key.strip(), _parse_scalar(raw), must_exist=not add)
    return tree


def _parse_scalar(raw: str) -> Any:
    """An override value read as YAML, with a numeric fallback: YAML 1.1
    reads ``1e-4`` as a string (no dot in the mantissa), but override
    grammars take it as a float, and so does this."""
    if raw == "":
        return ""
    value = parse_yaml(raw, "override")
    if isinstance(value, str):
        try:
            return int(value)
        except ValueError:
            pass
        try:
            return float(value)
        except ValueError:
            pass
    return value


def resolve_interpolations(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve ``${a.b}`` references against the tree's root. A reference
    that is the whole string keeps the target's type; embedded references
    become text. Unresolvable references stay as they are."""
    missing = object()

    def resolve_value(v: Any, depth: int = 0) -> Any:
        if depth > 10:  # interpolation cycle guard
            return v
        if isinstance(v, str):
            m = _INTERP_RE.fullmatch(v)
            if m:
                tgt = select(tree, m.group(1), default=missing)
                return v if tgt is missing else resolve_value(tgt, depth + 1)

            def sub(mm):
                tgt = select(tree, mm.group(1), default=missing)
                return mm.group(0) if tgt is missing else str(tgt)

            return _INTERP_RE.sub(sub, v)
        if isinstance(v, dict):
            return {k: resolve_value(x, depth) for k, x in v.items()}
        if isinstance(v, list):
            return [resolve_value(x, depth) for x in v]
        return v

    out = resolve_value(tree)
    tree.clear()
    tree.update(out)
    return tree


def load_config(path: str, overrides: Sequence[str] = ()) -> Dict[str, Any]:
    """Compose ``path``, apply ``overrides``, resolve interpolations.

    An override ``group=name`` whose ``<dir>/<group>/<name>.yaml`` exists
    (or whose value is null) is a group override: it swaps which file the
    defaults list composes, like Hydra's ``model=gpt2m``. Every other
    override is a dotlist leaf override."""
    config_dir = os.path.dirname(os.path.abspath(path))
    group_ovs: Dict[str, Optional[str]] = {}
    leaf_ovs: List[str] = []
    for ov in overrides:
        if "=" in ov and not ov.startswith(("+", "~")):
            key, _, val = ov.partition("=")
            if "." not in key and (
                val in ("null", "None")
                or os.path.exists(os.path.join(config_dir, key, f"{val}.yaml"))
            ):
                group_ovs[key] = None if val in ("null", "None") else val
                continue
        leaf_ovs.append(ov)
    tree = compose(path, group_ovs)
    apply_overrides(tree, leaf_ovs)
    resolve_interpolations(tree)
    return tree


def to_flat_kwargs(section: Optional[Dict[str, Any]], allowed: Sequence[str]) -> Dict[str, Any]:
    """A config section's keys that name fields in ``allowed``, so that
    ``TrainConfig(**to_flat_kwargs(cfg.get("trainer"), fields))`` works with
    other keys in the tree (they are left out)."""
    if not section:
        return {}
    allowed_set = set(allowed)
    return {k: v for k, v in section.items() if k in allowed_set}
