"""HCL (HashiCorp Configuration Language v1) subset parser.

The port's copy of ``consul_tpu/utils/hcl.py``; it imports nothing of the reference package.

The reference's config builder accepts HCL beside JSON (reference
agent/config/builder.go:1-200, vendor/github.com/hashicorp/hcl); every
published Consul example config is written in it. This module parses
the HCL1 subset those configs actually use into plain dicts:

  - ``key = value`` assignments (idents or quoted keys)
  - values: strings (with escapes), integers, floats, bools,
    lists ``[...]``, objects ``{ k = v ... }``
  - blocks ``name { ... }`` and labeled blocks
    ``service "web" { ... }`` (labels nest: ``a "b" "c" {}`` is
    ``{"a": {"b": {"c": {...}}}}`` — HCL1 object-key chaining)
  - repeated blocks/keys merge: objects deep-merge; anything else
    collects into a list (HCL1's ExpandShorthand semantics, the shape
    hcl.Decode gives Go)
  - comments: ``#``, ``//``, ``/* ... */``

Grammar-complete HCL (interpolation, heredocs) is out of scope — the
reference's *config files* never use those (interpolation arrived with
HCL2/Terraform, not Consul agent configs).
"""

from __future__ import annotations

import re
from typing import Any

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>\#[^\n]*|//[^\n]*|/\*.*?\*/)
  | (?P<string>"(?:\\.|[^"\\])*")
  | (?P<float>-?\d+\.\d+(?:[eE][+-]?\d+)?|-?\d+[eE][+-]?\d+)
  | (?P<int>-?\d+)
  | (?P<punct>[={}\[\],:])
  | (?P<ident>[A-Za-z_][A-Za-z0-9_.-]*)
""", re.VERBOSE | re.DOTALL)

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\"}


class HCLError(ValueError):
    pass


def _tokenize(src: str):
    pos, line = 0, 1
    out = []
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise HCLError(f"line {line}: unexpected character {src[pos]!r}")
        kind = m.lastgroup
        text = m.group()
        line += text.count("\n")
        pos = m.end()
        if kind in ("ws", "comment"):
            continue
        out.append((kind, text, line))
    out.append(("eof", "", line))
    return out


def _unquote(s: str) -> str:
    body, out, i = s[1:-1], [], 0
    while i < len(body):
        c = body[i]
        if c == "\\" and i + 1 < len(body):
            nxt = body[i + 1]
            if nxt not in _ESCAPES:
                # Reject rather than silently mangle (Go's strconv
                # unquote errors on invalid escapes; dropping the
                # backslash would corrupt e.g. Windows paths).
                raise HCLError(f"invalid escape sequence \\{nxt} in {s}")
            out.append(_ESCAPES[nxt])
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind, text=None):
        k, t, line = self.next()
        if k != kind or (text is not None and t != text):
            raise HCLError(
                f"line {line}: expected {text or kind}, got {t or k!r}")
        return t

    # -- values --------------------------------------------------------
    def value(self) -> Any:
        kind, text, line = self.next()
        if kind == "string":
            return _unquote(text)
        if kind == "int":
            return int(text)
        if kind == "float":
            return float(text)
        if kind == "ident":
            if text == "true":
                return True
            if text == "false":
                return False
            if text == "null":
                return None
            raise HCLError(f"line {line}: bare identifier {text!r} as value")
        if (kind, text) == ("punct", "["):
            return self.list_value()
        if (kind, text) == ("punct", "{"):
            return self.object_body(closing="}")
        raise HCLError(f"line {line}: unexpected {text or kind!r} in value")

    def list_value(self) -> list:
        out = []
        while True:
            kind, text, _ = self.peek()
            if (kind, text) == ("punct", "]"):
                self.next()
                return out
            out.append(self.value())
            kind, text, _ = self.peek()
            if (kind, text) == ("punct", ","):
                self.next()

    # -- objects / blocks ---------------------------------------------
    def object_body(self, closing=None) -> dict:
        out: dict[str, Any] = {}
        while True:
            kind, text, line = self.peek()
            if kind == "eof":
                if closing is None:
                    return out
                raise HCLError(f"line {line}: unexpected EOF, missing "
                               f"{closing!r}")
            if closing is not None and (kind, text) == ("punct", closing):
                self.next()
                return out
            if kind not in ("ident", "string"):
                raise HCLError(f"line {line}: expected a key, got "
                               f"{text or kind!r}")
            self.next()
            key = _unquote(text) if kind == "string" else text
            # Label chain: block "label" ["label2"...] { ... }
            labels = []
            while self.peek()[0] == "string":
                labels.append(_unquote(self.next()[1]))
            kind2, text2, line2 = self.peek()
            if (kind2, text2) == ("punct", "{"):
                self.next()
                val: Any = self.object_body(closing="}")
                for lbl in reversed(labels):
                    val = {lbl: val}
            elif labels:
                raise HCLError(
                    f"line {line2}: labeled key {key!r} must open a block")
            else:
                if (kind2, text2) in (("punct", "="), ("punct", ":")):
                    self.next()
                else:
                    raise HCLError(
                        f"line {line2}: expected '=' or block after {key!r}")
                val = self.value()
            _merge(out, key, val)
            kind3, text3, _ = self.peek()
            if (kind3, text3) == ("punct", ","):
                self.next()


def _merge(out: dict, key: str, val: Any) -> None:
    """HCL1 repeated-key semantics: objects deep-merge, everything else
    collects into a list."""
    if key not in out:
        out[key] = val
        return
    cur = out[key]
    if isinstance(cur, dict) and isinstance(val, dict):
        for k, v in val.items():
            _merge(cur, k, v)
    elif isinstance(cur, list) and not isinstance(val, list):
        cur.append(val)
    else:
        out[key] = [cur, val]


def parse(src: str) -> dict:
    """Parse HCL source into a dict (the shape hcl.Decode gives Go)."""
    return _Parser(_tokenize(src)).object_body()


def load(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return parse(f.read())
