"""A strict reader of the YAML subset that `configs/*.yaml`, dotlist values
and the web UI's settings files use, with `yaml.safe_load`'s (YAML 1.1)
scalar resolution, and a writer (`safe_dump`) of the same subset that aims
at `yaml.safe_dump(data, sort_keys=True)`'s bytes. The card's machine has
no pyyaml, and the port never imports it.

The subset: block mappings nested by indentation (spaces), `#` comments,
plain, single-quoted and double-quoted scalars, flow lists (`[]`,
`[0.7, 1.0]`, nested), and block sequences of scalars under a key or at
the top (`key:\n- 0.5`, indentless as pyyaml writes them, or indented). A
scalar may run over several lines where it is folded as pyyaml folds it: a
plain one over lines indented past its key (joined by single spaces), a
quoted one until its closing quote (line breaks fold to a space, blank lines
to newlines, a double-quoted backslash at a line's end joins). A plain scalar
resolves as pyyaml's implicit resolvers do: `~`, `null` and an empty value
are None; `yes`/`on`/`true` (three spellings each) and their negatives are
booleans; YAML 1.1 ints (`1_000`, `0x10`, octal `010`, binary `0b1`,
sexagesimal `1:30`); floats need a dot (`1.0e+4`, `.5`, `.inf`, `.nan`), so
`1e-4` and `1.0e4` stay strings. Anything outside the subset raises
`YamlError`: anchors, aliases, tags, block scalars, block sequences of
anything but scalars, flow mappings, directives, document markers (so
multi-document streams), tabs, timestamps, merge keys, duplicate keys,
multi-line flow lists and blank or comment lines inside a multi-line plain
scalar. Nothing is guessed.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Tuple

__all__ = ["YamlError", "safe_dump", "safe_load"]


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


def _flow_breaks(buf: str, i: int, out: List[str], error) -> int:
    """Past the line break at buf[i - 1]: skip each following line's leading
    spaces, one newline into `out` for every blank line; refuse a document
    marker at a line's start. Returns the position of the next text."""
    while True:
        if buf.startswith(("---", "..."), i) and buf[i + 3:i + 4] in ("", " ", "\n"):
            raise error("a document marker inside a quoted scalar")
        while i < len(buf) and buf[i] == " ":
            i += 1
        if i < len(buf) and buf[i] == "\n":
            out.append("\n")
            i += 1
            continue
        return i


def _flow_scalar(buf: str, pos: int, error) -> Tuple[str, int]:
    """The quoted scalar opening at buf[pos] (`buf` may run over several
    lines, joined by newlines), folded as pyyaml's scanner folds it: spaces
    before a line break are dropped, a single break reads as a space, each
    blank line as a newline, a continuation line's indentation is dropped; in
    double quotes an escaped break (`\\` at a line's end) joins. Returns
    (value, position after the closing quote)."""
    q, i, out, n = buf[pos], pos + 1, [], len(buf)
    while True:
        while i < n and buf[i] not in " \n":
            c = buf[i]
            if q == "'" and c == "'":
                if buf[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            if q == '"' and c == '"':
                return "".join(out), i + 1
            if q == '"' and c == "\\":
                e = buf[i + 1:i + 2]
                if e == "\n":
                    i = _flow_breaks(buf, i + 2, out, error)
                    continue
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    i += 2
                    continue
                if e in _HEX_ESCAPES:
                    k = _HEX_ESCAPES[e]
                    digits = buf[i + 2:i + 2 + k]
                    if len(digits) != k or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                        raise error(f"bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    i += 2 + k
                    continue
                raise error(f"unsupported escape \\{e}")
            out.append(c)
            i += 1
        if i >= n:
            raise error("unterminated quoted scalar")
        j = i
        while j < n and buf[j] == " ":
            j += 1
        if j < n and buf[j] == "\n":
            brk: List[str] = []
            i = _flow_breaks(buf, j + 1, brk, error)
            out.append("".join(brk) if brk else " ")
        else:
            out.append(buf[i:j])
            i = j


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
        """A quoted scalar that closes on this line."""
        value, self.pos = _flow_scalar(self.text, self.pos, self.error)
        return value

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
        self.check_plain_start()
        return resolve_plain(self.plain(flow))

    def check_plain_start(self):
        """Refuse what may not start a plain scalar at the cursor."""
        c = self.text[self.pos:self.pos + 1]
        if c in _NOT_PLAIN_START or c == "]" or c == ",":
            raise self.error(f"{c!r} at the start of a value is outside the supported subset "
                             "(anchors, aliases, tags, block scalars, flow mappings, directives)")
        if c == "-" and self.text[self.pos + 1:self.pos + 2] in ("", " "):
            raise self.error("block sequences are outside the supported subset")
        if c in ("?",) and self.text[self.pos + 1:self.pos + 2] in ("", " "):
            raise self.error("complex keys are outside the supported subset")

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


def _is_entry(content: str) -> bool:
    """A block sequence entry's line: `- value` or a bare `-`."""
    return content == "-" or content.startswith("- ")


class _Doc:
    """The document's lines (`_lines`) and its raw text lines, which a quoted
    scalar running over several lines is read from."""

    def __init__(self, text: str):
        self.raw = [r.rstrip("\r") for r in text.splitlines()]
        self.lines = _lines(text)

    def value(self, cur: _Cursor, i: int, indent: int) -> Tuple[Any, int]:
        """The value at the cursor of the line before lines[i], whose node
        sits at column `indent`: a scalar (over further lines where it is
        folded) or a flow list. Returns (value, index of the next line)."""
        cur.skip_space()
        c = cur.text[cur.pos:cur.pos + 1]
        if c in ("'", '"'):
            buf = cur.text + "\n" + "\n".join(self.raw[cur.lineno:])
            value, end = _flow_scalar(buf, cur.pos, cur.error)
            last = cur.lineno + buf.count("\n", 0, end)
            if last > cur.lineno:  # go on reading the closing line
                start = buf.rfind("\n", 0, end) + 1
                stop = buf.find("\n", end)
                cur = _Cursor(buf[start:stop if stop >= 0 else len(buf)], last)
                cur.pos = end - start
                while i < len(self.lines) and self.lines[i][0] <= last:
                    i += 1
            else:
                cur.pos = end
            if not cur.at_end():
                raise cur.error("trailing text after a value")
            return value, self._no_deeper(i, indent)
        if c != "[":
            cur.check_plain_start()
            parts = [cur.plain(flow=False)]
            prev = cur.lineno
            # a comment ends a plain scalar: no line may continue it
            while cur.pos >= len(cur.text) and i < len(self.lines) \
                    and self.lines[i][1] > indent:
                n, _, content = self.lines[i]
                if n != prev + 1:
                    raise YamlError(f"line {n}: a blank or comment line inside a multi-line "
                                    "plain scalar is outside the supported subset")
                cur = _Cursor(content, n)
                parts.append(cur.plain(flow=False))
                prev, i = n, i + 1
            if not cur.at_end():
                raise cur.error("trailing text after a value")
            return resolve_plain(" ".join(parts)), self._no_deeper(i, indent)
        value = cur.value()
        if not cur.at_end():
            raise cur.error("trailing text after a value")
        return value, self._no_deeper(i, indent)

    def _no_deeper(self, i: int, indent: int) -> int:
        if i < len(self.lines) and self.lines[i][1] > indent:
            raise YamlError(f"line {self.lines[i][0]}: unexpected indentation after a value: "
                            f"{self.lines[i][2]!r}")
        return i

    def sequence(self, i: int, indent: int) -> Tuple[list, int]:
        """The block sequence of scalars whose `-` sit at `indent`, from
        lines[i]."""
        out: list = []
        while i < len(self.lines):
            n, ind, content = self.lines[i]
            if ind < indent:
                break
            if ind > indent:
                raise YamlError(f"line {n}: unexpected indentation: {content!r}")
            if not _is_entry(content):
                break
            cur = _Cursor(content, n)
            cur.pos = 1
            i += 1
            if cur.at_end():
                out.append(None)
                i = self._no_deeper(i, indent)
                continue
            value, i = self.value(cur, i, indent)
            out.append(value)
        return out, i

    def block(self, i: int, indent: int) -> Tuple[dict, int]:
        """The block mapping whose keys sit at `indent`, from lines[i]."""
        lines = self.lines
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
                nxt = lines[i] if i < len(lines) else None
                if nxt is not None and nxt[1] > indent:
                    if _is_entry(nxt[2]):
                        out[key], i = self.sequence(i, nxt[1])
                    else:
                        out[key], i = self.block(i, nxt[1])
                elif nxt is not None and nxt[1] == indent and _is_entry(nxt[2]):
                    out[key], i = self.sequence(i, indent)  # indentless, as pyyaml writes
                else:
                    out[key] = None
                continue
            if cur.text[cur.pos - 1] != " ":
                raise cur.error("expected a space after ':'")
            out[key], i = self.value(cur, i, indent)
        return out, i


def safe_load(text) -> Any:
    """Parse one document of the supported subset (a str, or a file opened
    for reading). Returns None for an empty document."""
    if not isinstance(text, str):
        text = text.read()
    doc = _Doc(text)
    lines = doc.lines
    if not lines:
        return None
    n, ind, content = lines[0]
    if _is_entry(content) or _key(_Cursor(content, n)) is not None:
        if ind != 0:
            raise YamlError(f"line {n}: the top-level node must start at column 0")
        out, i = doc.sequence(0, 0) if _is_entry(content) else doc.block(0, 0)
        if i != len(lines):
            raise YamlError(f"line {lines[i][0]}: text after the top-level node")
        return out
    if len(lines) > 1:
        raise YamlError(f"line {lines[1][0]}: a top-level scalar or flow list must be one line")
    cur = _Cursor(content, n)
    value = cur.value()
    if not cur.at_end():
        raise cur.error("trailing text after a value")
    return value


# ------------------------------------------------------------------ writer
_SPACE_OR_BREAK = "\0 \t\r\n\x85\u2028\u2029"
_BREAKS = "\n\x85\u2028\u2029"
_DQ_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\x09": "t", "\x0A": "n", "\x0B": "v",
               "\x0C": "f", "\x0D": "r", "\x1B": "e", '"': '"', "\\": "\\", "\x85": "N",
               "\xA0": "_", "\u2028": "L", "\u2029": "P"}


def _analyze(text: str) -> dict:
    """pyyaml's `Emitter.analyze_scalar` (unicode not allowed, as
    `safe_dump` defaults): which styles may write `text`."""
    if not text:
        return dict(multiline=False, block_plain=True, single=True, empty=True)
    block_ind = flow_ind = line_breaks = special = False
    leading_space = leading_break = trailing_space = trailing_break = False
    break_space = space_break = False
    if text.startswith(("---", "...")):
        block_ind = flow_ind = True
    preceded_ws = True
    followed_ws = len(text) == 1 or text[1] in _SPACE_OR_BREAK
    prev_space = prev_break = False
    for index, ch in enumerate(text):
        if index == 0:
            if ch in "#,[]{}&*!|>'\"%@`":
                flow_ind = block_ind = True
            if ch in "?:":
                flow_ind = True
                block_ind = block_ind or followed_ws
            if ch == "-" and followed_ws:
                flow_ind = block_ind = True
        else:
            if ch in ",?[]{}":
                flow_ind = True
            if ch == ":":
                flow_ind = True
                block_ind = block_ind or followed_ws
            if ch == "#" and preceded_ws:
                flow_ind = block_ind = True
        if ch in _BREAKS:
            line_breaks = True
        if not (ch == "\n" or "\x20" <= ch <= "\x7E"):
            special = True
        if ch == " ":
            leading_space = leading_space or index == 0
            trailing_space = trailing_space or index == len(text) - 1
            break_space = break_space or prev_break
            prev_space, prev_break = True, False
        elif ch in _BREAKS:
            leading_break = leading_break or index == 0
            trailing_break = trailing_break or index == len(text) - 1
            space_break = space_break or prev_space
            prev_space, prev_break = False, True
        else:
            prev_space = prev_break = False
        preceded_ws = ch in _SPACE_OR_BREAK
        followed_ws = index + 2 >= len(text) or text[index + 2] in _SPACE_OR_BREAK
    block_plain = single = True
    if leading_space or leading_break or trailing_space or trailing_break:
        block_plain = False
    if break_space:
        block_plain = single = False
    if space_break or special:
        block_plain = single = False
    if line_breaks or block_ind:
        block_plain = False
    return dict(multiline=line_breaks, block_plain=block_plain, single=single, empty=False)


def _represent(value) -> Tuple[str, bool]:
    """(text, whether a plain spelling of it reads back as the same value),
    as pyyaml's SafeRepresenter and resolver make them."""
    if value is None:
        return "null", True
    if isinstance(value, bool):
        return ("true" if value else "false"), True
    if isinstance(value, int):
        return str(value), True
    if isinstance(value, float):
        if value != value:
            return ".nan", True
        if value in (math.inf, -math.inf):
            return (".inf" if value > 0 else "-.inf"), True
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text, True
    if isinstance(value, str):
        try:
            return value, isinstance(resolve_plain(value), str)
        except YamlError:  # a timestamp, merge or value key: not a str
            return value, False
    raise YamlError(f"{type(value).__name__} values are outside the supported subset")


class _Emitter:
    """The part of pyyaml's emitter that block mappings, indentless block
    sequences and scalars take: its column, whitespace and indentation state
    and its scalar writers, folding at `width` columns."""

    def __init__(self, width: int = 80):
        self.out: List[str] = []
        self.width = width
        self.column, self.indent = 0, 0
        self.whitespace = self.indention = True

    def write(self, data: str):
        self.column += len(data)
        self.out.append(data)

    def line_break(self):
        self.whitespace = self.indention = True
        self.column = 0
        self.out.append("\n")

    def write_indent(self):
        if not self.indention or self.column > self.indent or (
                self.column == self.indent and not self.whitespace):
            self.line_break()
        if self.column < self.indent:
            self.whitespace = True
            self.write(" " * (self.indent - self.column))

    def indicator(self, text: str, need_whitespace: bool, whitespace: bool = False,
                  indention: bool = False):
        self.write(text if self.whitespace or not need_whitespace else " " + text)
        self.whitespace = whitespace
        self.indention = self.indention and indention

    def scalar(self, value, simple_key: bool = False):
        text, implicit = _represent(value)
        a = _analyze(text)
        split = not simple_key
        if simple_key and (len(text) > 128 or a["multiline"]):
            raise YamlError(f"key {text!r} is outside the supported subset")
        if implicit and not (simple_key and (a["empty"] or a["multiline"])) and a["block_plain"]:
            self.plain(text, split)
        elif a["single"] and not (simple_key and a["multiline"]):
            self.single_quoted(text, split)
        else:
            self.double_quoted(text, split)

    def plain(self, text: str, split: bool):
        if not text:
            return
        if not self.whitespace:
            self.write(" ")
        self.whitespace = self.indention = False
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if start + 1 == end and self.column > self.width and split:
                        self.write_indent()
                        self.whitespace = self.indention = False
                    else:
                        self.write(text[start:end])
                    start = end
            elif ch is None or ch in " " + _BREAKS:
                self.write(text[start:end])
                start = end
            if ch is not None:
                spaces, breaks = ch == " ", ch in _BREAKS
            end += 1

    def single_quoted(self, text: str, split: bool):
        self.indicator("'", True)
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch is None or ch != " ":
                    if (start + 1 == end and self.column > self.width and split
                            and start != 0 and end != len(text)):
                        self.write_indent()
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    if text[start] == "\n":
                        self.line_break()
                    for br in text[start:end]:
                        if br == "\n":
                            self.line_break()
                        else:
                            self.line_break()
                            self.out[-1] = br
                    self.write_indent()
                    start = end
            elif ch is None or ch in " " + _BREAKS or ch == "'":
                if start < end:
                    self.write(text[start:end])
                    start = end
            if ch == "'":
                self.write("''")
                start = end + 1
            if ch is not None:
                spaces, breaks = ch == " ", ch in _BREAKS
            end += 1
        self.indicator("'", False)

    def double_quoted(self, text: str, split: bool):
        self.indicator('"', True)
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if ch is None or ch in '"\\\x85\u2028\u2029\uFEFF' or not "\x20" <= ch <= "\x7E":
                if start < end:
                    self.write(text[start:end])
                    start = end
                if ch is not None:
                    if ch in _DQ_ESCAPES:
                        data = "\\" + _DQ_ESCAPES[ch]
                    elif ch <= "\xFF":
                        data = "\\x%02X" % ord(ch)
                    elif ch <= "\uFFFF":
                        data = "\\u%04X" % ord(ch)
                    else:
                        data = "\\U%08X" % ord(ch)
                    self.write(data)
                    start = end + 1
            if (0 < end < len(text) - 1 and (ch == " " or start >= end)
                    and self.column + (end - start) > self.width and split):
                data = text[start:end] + "\\"
                if start < end:
                    start = end
                self.write(data)
                self.write_indent()
                self.whitespace = self.indention = False
                if text[start] == " ":
                    self.write("\\")
            end += 1
        self.indicator('"', False)

    def node(self, value, in_mapping: bool):
        """A mapping value or sequence entry after its `:` or `-`."""
        if isinstance(value, dict):
            if not value:  # pyyaml writes `{}`, a flow mapping
                raise YamlError("an empty mapping is outside the supported subset")
            self.mapping(value, self.indent + 2)
        elif isinstance(value, (list, tuple)):
            if not value:
                self.indicator("[", True, whitespace=True)
                self.indicator("]", False)
                return
            if not in_mapping:
                raise YamlError("a sequence inside a sequence is outside the supported subset")
            self.sequence(value, self.indent)  # indentless under a key
        else:
            saved, self.indent = self.indent, self.indent + 2
            self.scalar(value)
            self.indent = saved

    def mapping(self, data: dict, indent: int):
        saved, self.indent = self.indent, indent
        items = list(data.items())
        try:
            items.sort()
        except TypeError:
            pass
        for key, value in items:
            self.write_indent()
            if isinstance(key, (dict, list, tuple)):
                raise YamlError("a collection key is outside the supported subset")
            self.scalar(key, simple_key=True)
            self.indicator(":", False)
            self.node(value, in_mapping=True)
        self.indent = saved

    def sequence(self, data, indent: int):
        saved, self.indent = self.indent, indent
        for value in data:
            if isinstance(value, dict):
                raise YamlError("a mapping inside a sequence is outside the supported subset")
            self.write_indent()
            self.indicator("-", True, indention=True)
            self.node(value, in_mapping=False)
        self.indent = saved


def safe_dump(data) -> str:
    """`data` (a mapping, or a list, of scalars, lists of scalars and such
    mappings) as `yaml.safe_dump(data, sort_keys=True)` writes it: block
    mappings with keys sorted, block sequences indentless under a key, `[]`
    for an empty list (an empty mapping is refused: pyyaml writes `{}`), scalars as pyyaml represents them (`null`,
    `true`, `1.0e-05`, `.inf`), quoted where a plain spelling would read as
    another value or another node, long ones folded at 80 columns."""
    em = _Emitter()
    if isinstance(data, dict) and data:
        em.mapping(data, 0)
    elif isinstance(data, (list, tuple)) and data:
        em.sequence(data, 0)
    else:
        raise YamlError("the top level must be a non-empty mapping or list")
    em.write_indent()
    return "".join(em.out)
