"""A strict reader of the YAML subset that `configs/*.yaml` and dotlist
values use, with `yaml.safe_load`'s (YAML 1.1) scalar resolution. The card's
machine has no pyyaml, and the port never imports it.

The subset: block mappings nested by indentation (spaces), `#` comments,
plain, single-quoted and double-quoted scalars, and flow lists (`[]`,
`[0.7, 1.0]`, nested). A plain scalar resolves as pyyaml's implicit
resolvers do: `~`, `null` and an empty value are None; `yes`/`on`/`true`
(three spellings each) and their negatives are booleans; YAML 1.1 ints
(`1_000`, `0x10`, octal `010`, binary `0b1`, sexagesimal `1:30`); floats
need a dot (`1.0e+4`, `.5`, `.inf`, `.nan`), so `1e-4` and `1.0e4` stay
strings. Anything outside the subset raises `YamlError`: anchors, aliases,
tags, block scalars, block sequences, flow mappings, directives, document
markers (so multi-document streams), tabs, timestamps, merge keys and
duplicate keys. Nothing is guessed.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Tuple

__all__ = ["YamlError", "safe_load"]


class YamlError(ValueError):
    pass


_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
# a plain scalar may not start with these (YAML indicators)
_NOT_PLAIN_START = set("&*!|>{}%@`")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(value: str, cast):
    out, base = cast(0), 1
    for part in reversed(value.split(":")):
        out += cast(part) * base
        base *= 60
    return out


def resolve_plain(text: str) -> Any:
    """A plain scalar's value as `yaml.safe_load` resolves it."""
    first = text[:1]
    if first in set("yYnNtTfFoO") and _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if first in set("-+0123456789.") and _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        return sign * (_sexagesimal(v, float) if ":" in v else float(v))
    if first in set("-+0123456789") and _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if _NULL.match(text):
        return None
    if first in set("0123456789") and _TIMESTAMP.match(text):
        raise YamlError(f"timestamp {text!r} is outside the supported subset")
    if text in ("<<", "="):
        raise YamlError(f"{text!r} (merge key / value tag) is outside the supported subset")
    return text


class _Cursor:
    """A scalar or flow-list reader over one line's text, from `pos`."""

    def __init__(self, text: str, lineno: int):
        self.text, self.pos, self.lineno = text, 0, lineno

    def error(self, msg: str) -> YamlError:
        return YamlError(f"line {self.lineno}: {msg}: {self.text!r}")

    def skip_space(self):
        while self.pos < len(self.text) and self.text[self.pos] == " ":
            self.pos += 1

    def at_end(self) -> bool:
        """True at the end of the text or at a comment."""
        self.skip_space()
        return self.pos >= len(self.text) or (
            self.text[self.pos] == "#" and (self.pos == 0 or self.text[self.pos - 1] == " "))

    def quoted(self) -> str:
        q = self.text[self.pos]
        i, out = self.pos + 1, []
        while i < len(self.text):
            c = self.text[i]
            if q == "'" and c == "'":
                if self.text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                self.pos = i + 1
                return "".join(out)
            if q == '"' and c == '"':
                self.pos = i + 1
                return "".join(out)
            if q == '"' and c == "\\":
                e = self.text[i + 1:i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    i += 2
                    continue
                if e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    digits = self.text[i + 2:i + 2 + n]
                    if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                        raise self.error(f"bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    i += 2 + n
                    continue
                raise self.error(f"unsupported escape \\{e}")
            out.append(c)
            i += 1
        raise self.error("unterminated quoted scalar (multi-line scalars are not supported)")

    def plain(self, flow: bool) -> str:
        """A plain scalar up to a comment, the end, or (in a flow list) `,`
        or `]`; `: ` inside it is refused."""
        start = i = self.pos
        stop = ",[]{}" if flow else ""
        while i < len(self.text):
            c = self.text[i]
            if c in stop:
                break
            if c == "#" and i > start and self.text[i - 1] == " ":
                break
            if c == ":" and (i + 1 == len(self.text) or self.text[i + 1] == " "
                             or (flow and self.text[i + 1] in ",]")):
                raise self.error("a mapping inside a value is outside the supported subset")
            i += 1
        self.pos = i
        return self.text[start:i].rstrip(" ")

    def value(self, flow: bool = False) -> Any:
        self.skip_space()
        c = self.text[self.pos:self.pos + 1]
        if c == "[":
            return self.flow_list()
        if c in ("'", '"'):
            return self.quoted()
        if c in _NOT_PLAIN_START or c == "]" or c == ",":
            raise self.error(f"{c!r} at the start of a value is outside the supported subset "
                             "(anchors, aliases, tags, block scalars, flow mappings, directives)")
        if c == "-" and self.text[self.pos + 1:self.pos + 2] in ("", " "):
            raise self.error("block sequences are outside the supported subset")
        if c in ("?",) and self.text[self.pos + 1:self.pos + 2] in ("", " "):
            raise self.error("complex keys are outside the supported subset")
        return resolve_plain(self.plain(flow))

    def flow_list(self) -> List[Any]:
        self.pos += 1  # [
        out: List[Any] = []
        while True:
            self.skip_space()
            if self.pos >= len(self.text):
                raise self.error("unterminated flow list (multi-line flow lists are not "
                                 "supported)")
            if self.text[self.pos] == "]":
                self.pos += 1
                return out
            out.append(self.value(flow=True))
            self.skip_space()
            c = self.text[self.pos:self.pos + 1]
            if c == ",":
                self.pos += 1
            elif c != "]":
                raise self.error(f"expected ',' or ']' in a flow list, got {c!r}")


def _lines(text: str) -> List[Tuple[int, int, str]]:
    """(line number, indent, content) of every line that is not blank or a
    comment."""
    out = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw:
            raise YamlError(f"line {n}: tabs are outside the supported subset")
        body = raw.rstrip(" \r")
        stripped = body.lstrip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        if n == 1 and raw.startswith("﻿"):
            raise YamlError("a byte-order mark is outside the supported subset")
        if stripped.startswith(("---", "...")) and len(body) - len(stripped) == 0 and (
                stripped[3:4] in ("", " ")):
            raise YamlError(f"line {n}: document markers (and so multi-document streams) "
                            "are outside the supported subset")
        if stripped.startswith("%") and body == stripped:
            raise YamlError(f"line {n}: directives are outside the supported subset")
        out.append((n, len(body) - len(stripped), stripped))
    return out


def _key(cur: _Cursor) -> Optional[Any]:
    """The mapping key at the cursor, leaving it after `:`; None when the
    line is not `key:` / `key: value`."""
    c = cur.text[:1]
    if c in ("'", '"'):
        key = cur.quoted()
        if cur.text[cur.pos:cur.pos + 1] != ":":
            return None
        cur.pos += 1
        return key
    i = 0
    while i < len(cur.text):
        if cur.text[i] == ":" and (i + 1 == len(cur.text) or cur.text[i + 1] == " "):
            break
        if cur.text[i] == "#" and i > 0 and cur.text[i - 1] == " ":
            return None
        i += 1
    else:
        return None
    raw = cur.text[:i].rstrip(" ")
    if not raw or raw[0] in _NOT_PLAIN_START or raw[0] in "[]," or raw.startswith(("- ", "? ")) \
            or raw in ("-", "?"):
        raise cur.error("this key is outside the supported subset")
    cur.pos = i + 1
    return resolve_plain(raw)


def _block(lines, i: int, indent: int) -> Tuple[dict, int]:
    """The block mapping whose keys sit at `indent`, from lines[i]."""
    out: dict = {}
    while i < len(lines):
        n, ind, content = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise YamlError(f"line {n}: unexpected indentation: {content!r}")
        cur = _Cursor(content, n)
        key = _key(cur)
        if key is None:
            raise YamlError(f"line {n}: expected 'key:' in a block mapping: {content!r}")
        try:
            hash(key)
        except TypeError:
            raise cur.error("unhashable key")
        if key in out:
            raise cur.error(f"duplicate key {key!r}")
        i += 1
        if cur.at_end():
            if i < len(lines) and lines[i][1] > indent:
                out[key], i = _block(lines, i, lines[i][1])
            else:
                out[key] = None
            continue
        if cur.text[cur.pos - 1] != " ":
            raise cur.error("expected a space after ':'")
        out[key] = cur.value()
        if not cur.at_end():
            raise cur.error("trailing text after a value")
        if i < len(lines) and lines[i][1] > indent:
            raise YamlError(f"line {lines[i][0]}: unexpected indentation after a value: "
                            f"{lines[i][2]!r} (multi-line plain scalars are not supported)")
    return out, i


def safe_load(text) -> Any:
    """Parse one document of the supported subset (a str, or a file opened
    for reading). Returns None for an empty document."""
    if not isinstance(text, str):
        text = text.read()
    lines = _lines(text)
    if not lines:
        return None
    n, ind, content = lines[0]
    cur = _Cursor(content, n)
    if _key(_Cursor(content, n)) is not None:
        if ind != 0:
            raise YamlError(f"line {n}: the top-level mapping must start at column 0")
        out, i = _block(lines, 0, 0)
        if i != len(lines):
            raise YamlError(f"line {lines[i][0]}: text after the top-level mapping")
        return out
    if len(lines) > 1:
        raise YamlError(f"line {lines[1][0]}: a top-level scalar or flow list must be one line")
    value = cur.value()
    if not cur.at_end():
        raise cur.error("trailing text after a value")
    return value
