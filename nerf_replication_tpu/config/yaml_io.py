"""YAML reader and writer for the subset the configs use.

``safe_load`` returns what ``yaml.safe_load`` (PyYAML, YAML 1.1) returns
for documents made of block mappings and sequences, flow ``[...]`` /
``{...}`` collections, comments, plain and quoted scalars — including
the YAML 1.1 resolver rules: ``5e-3`` (no dot) stays a string, ``1.`` is
a float, ``yes``/``on``/``True`` are booleans, ``~`` is null. Anchors,
aliases, tags, block scalars (``|``, ``>``) and multi-document streams
are refused with ``ValueError``.

``safe_dump`` writes block-style YAML (PyYAML's default layout) that
both readers load back to the same value.
"""

from __future__ import annotations

import re

# -- scalar resolution (PyYAML resolver.py, YAML 1.1 implicit tags) ------------

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN))$")
_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+"
    r"|[-+]?0[0-7_]+"
    r"|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TRUE = {"yes", "true", "on"}


def _sexagesimal(text: str, cast):
    sign = -1 if text[0] == "-" else 1
    value = 0
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + cast(part)
    return sign * value


def _to_int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t[0] == "-" else 1
    if t[0] in "+-":
        t = t[1:]
    if t == "0":
        return 0
    if t.startswith("0b"):
        return sign * int(t[2:], 2)
    if t.startswith("0x"):
        return sign * int(t[2:], 16)
    if t[0] == "0":
        return sign * int(t, 8)
    if ":" in t:
        return sign * _sexagesimal(t, int)
    return sign * int(t)


def _to_float(text: str) -> float:
    t = text.replace("_", "").lower()
    sign = -1.0 if t[0] == "-" else 1.0
    if t[0] in "+-":
        t = t[1:]
    if t == ".inf":
        return sign * float("inf")
    if t == ".nan":
        return float("nan")
    if ":" in t:
        return sign * _sexagesimal(t, float)
    return sign * float(t)


def resolve_plain(text: str):
    """A plain (unquoted) scalar -> its YAML 1.1 value."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        return _to_int(text)
    if _FLOAT.match(text):
        return _to_float(text)
    return text


# -- reader ---------------------------------------------------------------------

_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX = {"x": 2, "u": 4, "U": 8}


def _strip_comment(line: str) -> str:
    """Drop a trailing ``# comment`` that sits outside quotes."""
    quote = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote == "'":
            if ch == "'":
                if line[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if ch == "\\":
                i += 1
            elif ch == '"':
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


class _Flow:
    """Parser over one node text: flow collections and scalars."""

    def __init__(self, text: str):
        self.s = text
        self.i = 0

    def error(self, msg):
        raise ValueError(f"YAML: {msg} at column {self.i} of {self.s!r}")

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t\n":
            self.i += 1

    def node(self, in_flow: bool):
        self.ws()
        if self.i >= len(self.s):
            return None
        ch = self.s[self.i]
        if ch == "[":
            return self.seq()
        if ch == "{":
            return self.mapping()
        if ch == "'":
            return self.single()
        if ch == '"':
            return self.double()
        if ch in "&*!|>%@`":
            self.error(f"unsupported YAML construct {ch!r}")
        return resolve_plain(self.plain(in_flow))

    def plain(self, in_flow: bool) -> str:
        start = self.i
        stops = ",[]{}" if in_flow else ""
        while self.i < len(self.s):
            ch = self.s[self.i]
            if ch in stops:
                break
            if ch == ":" and (self.i + 1 == len(self.s)
                              or self.s[self.i + 1] in " \t\n"
                              or (in_flow and self.s[self.i + 1] in ",]}")):
                break
            self.i += 1
        return " ".join(self.s[start:self.i].split())

    def single(self) -> str:
        out = []
        self.i += 1
        while True:
            if self.i >= len(self.s):
                self.error("unterminated single-quoted scalar")
            ch = self.s[self.i]
            if ch == "'":
                if self.s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            out.append(ch)
            self.i += 1

    def double(self) -> str:
        out = []
        self.i += 1
        while True:
            if self.i >= len(self.s):
                self.error("unterminated double-quoted scalar")
            ch = self.s[self.i]
            if ch == '"':
                self.i += 1
                return "".join(out)
            if ch == "\\":
                esc = self.s[self.i + 1:self.i + 2]
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                    self.i += 2
                elif esc in _HEX:
                    n = _HEX[esc]
                    out.append(chr(int(self.s[self.i + 2:self.i + 2 + n], 16)))
                    self.i += 2 + n
                else:
                    self.error(f"unknown escape \\{esc}")
                continue
            out.append(ch)
            self.i += 1

    def expect(self, ch):
        self.ws()
        if self.s[self.i:self.i + 1] != ch:
            self.error(f"expected {ch!r}")
        self.i += 1

    def seq(self) -> list:
        self.i += 1
        out = []
        while True:
            self.ws()
            if self.s[self.i:self.i + 1] == "]":
                self.i += 1
                return out
            out.append(self.node(in_flow=True))
            self.ws()
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
            elif self.s[self.i:self.i + 1] != "]":
                self.error("expected ',' or ']'")

    def mapping(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self.ws()
            if self.s[self.i:self.i + 1] == "}":
                self.i += 1
                return out
            key = self.node(in_flow=True)
            self.ws()
            value = None
            if self.s[self.i:self.i + 1] == ":":
                self.i += 1
                self.ws()
                if self.s[self.i:self.i + 1] not in (",", "}"):
                    value = self.node(in_flow=True)
            out[key] = value
            self.ws()
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
            elif self.s[self.i:self.i + 1] != "}":
                self.error("expected ',' or '}'")

    def done(self):
        self.ws()
        if self.i != len(self.s):
            self.error("trailing characters")


def _scalar_or_flow(text: str):
    p = _Flow(text)
    value = p.node(in_flow=False)
    p.done()
    return value


def _split_key(text: str):
    """``key: value`` / ``key:`` -> (key, value text) or None when the
    line is not a mapping entry."""
    p = _Flow(text)
    if text[:1] in "[{":
        return None
    if text[:1] in "'\"":
        key = p.single() if text[0] == "'" else p.double()
        rest = text[p.i:].lstrip(" \t")
        if rest[:1] != ":" or rest[1:2] not in ("", " ", "\t"):
            return None
        return key, rest[1:].strip()
    p.plain(in_flow=False)
    if p.i >= len(text) or text[p.i] != ":":
        return None
    return resolve_plain(text[:p.i].strip()), text[p.i + 1:].strip()


class _Block:
    def __init__(self, lines):
        self.lines = lines          # [(indent, text)]
        self.k = 0

    def peek(self):
        return self.lines[self.k] if self.k < len(self.lines) else None

    def node(self, indent: int):
        """The block node whose first line is at ``indent``."""
        line = self.peek()
        if line is None or line[0] < indent:
            return None
        ind, text = line
        if text == "-" or text.startswith("- "):
            return self.sequence(ind)
        if _split_key(text) is not None:
            return self.mapping(ind)
        self.k += 1
        return _scalar_or_flow(text)

    def value(self, rest: str, parent_indent: int, seq_ok: bool):
        """Value of a ``key:`` or ``-`` entry: inline text, or the nested
        block on the following lines."""
        if rest:
            return _scalar_or_flow(rest)
        nxt = self.peek()
        if nxt is None:
            return None
        ind, text = nxt
        if ind > parent_indent:
            return self.node(ind)
        if seq_ok and ind == parent_indent and (
                text == "-" or text.startswith("- ")):
            return self.sequence(ind)
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while True:
            line = self.peek()
            if line is None or line[0] != indent:
                return out
            kv = _split_key(line[1])
            if kv is None:
                raise ValueError(f"YAML: expected 'key: value', got {line[1]!r}")
            self.k += 1
            out[kv[0]] = self.value(kv[1], indent, seq_ok=True)

    def sequence(self, indent: int) -> list:
        out = []
        while True:
            line = self.peek()
            if line is None or line[0] != indent or not (
                    line[1] == "-" or line[1].startswith("- ")):
                return out
            rest = line[1][1:].lstrip(" ")
            if rest and (rest.startswith("- ") or _split_key(rest)):
                # compact nested node: re-read the item as its own line
                self.lines[self.k] = (indent + len(line[1]) - len(rest), rest)
                out.append(self.node(self.lines[self.k][0]))
            else:
                self.k += 1
                out.append(self.value(rest, indent, seq_ok=False))


def _logical_lines(text: str):
    """Comment-free (indent, text) lines; a flow collection that spans
    lines is joined into one."""
    out, pending = [], None
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("YAML: tab in indentation")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line.strip() in ("---", "..."):
            if out or pending:
                raise ValueError("YAML: only one document is supported")
            continue
        if pending is not None:
            pending = (pending[0], pending[1] + " " + line.strip())
        else:
            pending = (len(line) - len(line.lstrip()), line.strip())
        depth = 0
        quote = None
        for ch in pending[1]:
            if quote:
                quote = None if ch == quote else quote
            elif ch in "'\"":
                quote = ch
            elif ch in "[{":
                depth += 1
            elif ch in "]}":
                depth -= 1
        if depth <= 0:
            out.append(pending)
            pending = None
    if pending is not None:
        raise ValueError("YAML: unterminated flow collection")
    return out


def safe_load(stream):
    """YAML text (or a readable file) -> Python value, as PyYAML's
    ``safe_load`` gives it."""
    text = stream.read() if hasattr(stream, "read") else str(stream)
    lines = _logical_lines(text)
    if not lines:
        return None
    block = _Block(lines)
    value = block.node(lines[0][0])
    if block.peek() is not None:
        raise ValueError(f"YAML: unexpected line {block.peek()[1]!r}")
    return value


# -- writer ---------------------------------------------------------------------

_PLAIN_OK = re.compile(r"^[A-Za-z0-9_./+=()-](?:[A-Za-z0-9_./+=() -]*"
                       r"[A-Za-z0-9_./+=()-])?$")


def _scalar_text(v) -> str:
    if hasattr(v, "item") and not isinstance(v, (str, bytes)):
        v = v.item()            # numpy scalars
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        if _PLAIN_OK.match(v) and resolve_plain(v) == v and not v.startswith("-"):
            return v
        if all(ch.isprintable() for ch in v):
            return "'" + v.replace("'", "''") + "'"
        body = v.replace("\\", "\\\\").replace('"', '\\"')
        for ch in set(body):
            if not ch.isprintable():
                body = body.replace(ch, "\\n" if ch == "\n"
                                    else f"\\u{ord(ch):04x}")
        return '"' + body + '"'
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def _dump(v, indent: int, out: list):
    pad = " " * indent
    if isinstance(v, dict):
        for k, x in v.items():
            key = _scalar_text(k)
            if isinstance(x, dict) and x:
                out.append(f"{pad}{key}:")
                _dump(x, indent + 2, out)
            elif isinstance(x, (list, tuple)) and x:
                out.append(f"{pad}{key}:")
                _dump(x, indent, out)      # sequences sit at the key's indent
            else:
                out.append(f"{pad}{key}: {_inline(x)}")
    else:
        for x in v:
            if isinstance(x, (dict, list, tuple)) and x:
                sub: list = []
                _dump(x, indent + 2, sub)
                out.append(f"{pad}- {sub[0][indent + 2:]}")
                out.extend(sub[1:])
            else:
                out.append(f"{pad}- {_inline(x)}")


def _inline(x) -> str:
    if isinstance(x, dict):
        return "{}"
    if isinstance(x, (list, tuple)):
        return "[]"
    return _scalar_text(x)


def safe_dump(value) -> str:
    """Python dict/list/scalar tree -> block-style YAML text."""
    if isinstance(value, (dict, list, tuple)) and value:
        out: list = []
        _dump(value, 0, out)
        return "\n".join(out) + "\n"
    return _inline(value) + "\n"
