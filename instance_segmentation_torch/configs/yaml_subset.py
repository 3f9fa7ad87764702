"""A reader for the subset of YAML that the repository's config files use.

Gives what ``yaml.safe_load`` gives on: block mappings and block lists
(the list at the key's indentation, as ``yaml.safe_dump`` writes it, or
deeper), flow lists (nested too), ``{}`` and ``[]``, comments, empty values
(``None``), and plain, single-quoted and double-quoted scalars resolved by
PyYAML's YAML 1.1 rules: ``null``/``~``, ``true``/``yes``/``on`` and their
opposites, decimal, hex, octal and binary integers, and floats, which need a
dot and a signed exponent (so ``1e-4`` stays the string ``'1e-4'`` while
``1.0e-4`` is a float). Anything else (anchors, aliases, tags, multi-line
and block scalars, flow mappings, mappings inside lists, documents,
sexagesimal numbers, tabs) raises ``YamlSubsetError``: it never guesses.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")}}
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_NOT_PLAIN = set("-?:,[]{}#&*!|>'\"%@`")


class YamlSubsetError(ValueError):
    """The text lies outside the subset this reader takes."""


def _resolve(text: str) -> Any:
    """A plain scalar as PyYAML's SafeLoader resolves it."""
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _SEXAGESIMAL.match(text):
        raise YamlSubsetError(f"sexagesimal number {text!r} is outside the subset")
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * float(v)
    return text


def _plain_start(text: str) -> bool:
    """A plain scalar may start with ``text[0]`` (``-``, ``?`` and ``:``
    only before a non-space)."""
    return text[0] not in _NOT_PLAIN or (text[0] in "-?:" and text[1:2] not in ("", " "))


def _quoted(text: str, pos: int) -> Tuple[str, int]:
    """The quoted scalar starting at ``text[pos]``; returns (value, index
    after the closing quote)."""
    quote, out, i = text[pos], [], pos + 1
    while i < len(text):
        ch = text[i]
        if quote == "'":
            if ch == "'":
                if text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(ch)
            i += 1
            continue
        if ch == '"':
            return "".join(out), i + 1
        if ch == "\\":
            code = text[i + 1:i + 2]
            if code in _ESCAPES:
                out.append(_ESCAPES[code])
                i += 2
            elif code in _HEX_ESCAPES:
                n = _HEX_ESCAPES[code]
                digits = text[i + 2:i + 2 + n]
                if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                    raise YamlSubsetError(f"bad escape in {text!r}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
            else:
                raise YamlSubsetError(f"escape \\{code} in {text!r} is outside the subset")
            continue
        out.append(ch)
        i += 1
    raise YamlSubsetError(f"unterminated quoted scalar (multi-line scalars are outside the "
                          f"subset): {text!r}")


def _strip_comment(line: str) -> str:
    """``line`` without its comment (a ``#`` at the start or after a space,
    outside quoted scalars; a quote opens one only where a value starts)."""
    i, quote = 0, None
    while i < len(line):
        ch = line[i]
        if quote is None:
            if ch in "'\"" and line[:i].rstrip()[-1:] in ("", ":", "-", "[", ","):
                quote = ch
            elif ch == "#" and (i == 0 or line[i - 1] == " "):
                return line[:i].rstrip()
        elif quote == '"' and ch == "\\":
            i += 1
        elif ch == quote:
            if quote == "'" and line[i + 1:i + 2] == "'":
                i += 1
            else:
                quote = None
        i += 1
    return line.rstrip()


def _flow(text: str, pos: int) -> Tuple[Any, int]:
    """A flow list or a flow scalar at ``text[pos]`` (leading spaces skipped)."""
    while pos < len(text) and text[pos] == " ":
        pos += 1
    if pos < len(text) and text[pos] == "[":
        items, pos = [], pos + 1
        while True:
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if pos < len(text) and text[pos] == "]" and not items:
                return items, pos + 1
            item, pos = _flow(text, pos)
            items.append(item)
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if pos < len(text) and text[pos] == ",":
                pos += 1
            elif pos < len(text) and text[pos] == "]":
                return items, pos + 1
            else:
                raise YamlSubsetError(f"unterminated flow list: {text!r}")
    if pos < len(text) and text[pos] in "'\"":
        return _quoted(text, pos)
    end = pos
    while end < len(text) and text[end] not in ",[]{}":
        end += 1
    plain = text[pos:end].strip()
    if not plain or not _plain_start(plain) or ": " in plain or plain.endswith(":"):
        raise YamlSubsetError(f"flow item {plain!r} is outside the subset")
    return _resolve(plain), end


def _scalar(text: str) -> Any:
    """The value after ``key:`` or ``- `` on one line."""
    if text in ("{}", "[]"):
        return {} if text == "{}" else []
    if text[0] == "[":
        value, end = _flow(text, 0)
    elif text[0] in "'\"":
        value, end = _quoted(text, 0)
    else:
        if not _plain_start(text):
            raise YamlSubsetError(f"value {text!r} is outside the subset (anchor, alias, tag, "
                                  "block scalar or flow mapping)")
        if ": " in text or text.endswith(":"):
            raise YamlSubsetError(f"mapping values are not allowed here: {text!r}")
        return _resolve(text)
    if text[end:].strip():
        raise YamlSubsetError(f"text after a value: {text!r}")
    return value


def _split_key(content: str) -> Tuple[Any, str]:
    """(key, value text) of ``key: value`` / ``key:``."""
    if content[0] in "'\"":
        key, end = _quoted(content, 0)
        rest = content[end:]
        if not rest.startswith(":") or rest[1:2] not in ("", " "):
            raise YamlSubsetError(f"not a mapping entry: {content!r}")
        return key, rest[1:].strip()
    m = re.search(r":(?: |$)", content)
    if m is None:
        raise YamlSubsetError(f"not a mapping entry (multi-line scalars are outside the "
                              f"subset): {content!r}")
    key = content[:m.start()].rstrip()
    if not key or key[0] in _NOT_PLAIN:
        raise YamlSubsetError(f"key {key!r} is outside the subset")
    return _resolve(key), content[m.end():].strip()


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


class _Parser:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, str]] = []
        for number, raw in enumerate(text.splitlines(), 1):
            body = raw.lstrip(" ")
            if body.startswith("\t") or (body and "\t" in raw[:len(raw) - len(body)]):
                raise YamlSubsetError(f"line {number}: tab indentation is outside the subset")
            content = _strip_comment(body)
            if not content:
                continue
            if content in ("---", "...") or content.startswith(("--- ", "%")):
                raise YamlSubsetError(f"line {number}: documents and directives are outside "
                                      "the subset")
            self.lines.append((len(raw) - len(body), content))

    def block(self, i: int, indent: int) -> Tuple[Any, int]:
        if _is_item(self.lines[i][1]):
            return self.items(i, indent)
        return self.mapping(i, indent)

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out: dict = {}
        while i < len(self.lines) and self.lines[i][0] >= indent:
            ind, content = self.lines[i]
            if ind != indent or _is_item(content):
                raise YamlSubsetError(f"bad indentation at {content!r}")
            key, rest = _split_key(content)
            i += 1
            if rest:
                out[key] = _scalar(rest)
            elif i < len(self.lines) and self.lines[i][0] > indent:
                out[key], i = self.block(i, self.lines[i][0])
            elif i < len(self.lines) and self.lines[i][0] == indent and _is_item(self.lines[i][1]):
                out[key], i = self.items(i, indent)
            else:
                out[key] = None
        return out, i

    def items(self, i: int, indent: int) -> Tuple[list, int]:
        out = []
        while i < len(self.lines) and self.lines[i][0] == indent and _is_item(self.lines[i][1]):
            rest = self.lines[i][1][1:].strip()
            if not rest or _is_item(rest) or re.search(r":(?: |$)", rest) and rest[0] not in "'\"[":
                raise YamlSubsetError(f"nested block in a list item is outside the subset: "
                                      f"{self.lines[i][1]!r}")
            out.append(_scalar(rest))
            i += 1
        return out, i


def load(text: str) -> Any:
    """Parse ``text`` (see the module's docstring); ``None`` when empty."""
    parser = _Parser(text)
    if not parser.lines:
        return None
    indent = parser.lines[0][0]
    if len(parser.lines) == 1 and not _is_item(parser.lines[0][1]) \
            and not re.search(r":(?: |$)", parser.lines[0][1]):
        return _scalar(parser.lines[0][1])
    value, i = parser.block(0, indent)
    if i != len(parser.lines):
        raise YamlSubsetError(f"bad indentation at {parser.lines[i][1]!r}")
    return value


def load_file(path: str) -> Any:
    with open(path, "r") as f:
        return load(f.read())
