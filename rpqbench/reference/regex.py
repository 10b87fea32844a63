"""A parser of the RPQ syntax, written for the reference.

Syntax: ``a b`` concatenation, ``a|b`` union, postfix ``*``, ``+``,
``?``; ``.`` any forward label; ``{a|b, c}`` a class of labels; a label
is a bare word or a "quoted string", and ``^-1`` (or ``^{-1}``, ``⁻¹``)
after it or after a class's label traverses edges backwards.

The tree is built of tuples:

* ``("sym", labels, inverse)`` — one hop over a label set (``None``: any);
* ``("cat", parts)``, ``("alt", parts)``;
* ``("star", inner)``, ``("plus", inner)``, ``("opt", inner)``.
"""

from __future__ import annotations

import re

_INVERSE = ("^-1", "^{-1}", "⁻¹")
_SPECIAL = "()|*+?{}.,"
_WORD = re.compile(r'"[^"]*"(?:\^-1|\^\{-1\}|⁻¹)?|[^\s()|*+?{}.,"]+')


def tokens(text: str) -> list[tuple[str, str]]:
    """(kind, text) pairs; kind is the character for punctuation, else
    ``"word"``."""
    out, i = [], 0
    while i < len(text):
        c = text[i]
        if c.isspace():
            i += 1
        elif c in _SPECIAL:
            out.append((c, c))
            i += 1
        else:
            m = _WORD.match(text, i)
            if m is None:
                raise ValueError(f"bad character {c!r} at {i} in {text!r}")
            out.append(("word", m.group(0)))
            i = m.end()
    return out


def _label(word: str) -> tuple[str, bool]:
    for mark in _INVERSE:
        if word.endswith(mark):
            word, inv = word[: -len(mark)], True
            break
    else:
        inv = False
    if word.startswith('"') and word.endswith('"') and len(word) >= 2:
        word = word[1:-1]
    return word, inv


def parse(text: str):
    toks = tokens(text)
    pos = 0

    def peek():
        return toks[pos][0] if pos < len(toks) else None

    def take(kind):
        nonlocal pos
        if peek() != kind:
            raise ValueError(f"expected {kind!r} at token {pos} of {text!r}")
        pos += 1
        return toks[pos - 1][1]

    def alternation():
        parts = [sequence()]
        while peek() == "|":
            take("|")
            parts.append(sequence())
        return parts[0] if len(parts) == 1 else ("alt", tuple(parts))

    def sequence():
        parts = []
        while peek() not in (None, "|", ")", "}"):
            parts.append(postfix())
        if not parts:
            raise ValueError(f"empty term in {text!r}")
        return parts[0] if len(parts) == 1 else ("cat", tuple(parts))

    def postfix():
        node = atom()
        while peek() in ("*", "+", "?"):
            node = ({"*": "star", "+": "plus", "?": "opt"}[take(peek())], node)
        return node

    def atom():
        kind = peek()
        if kind == "(":
            take("(")
            node = alternation()
            take(")")
            return node
        if kind == ".":
            take(".")
            return ("sym", None, False)
        if kind == "word":
            name, inv = _label(take("word"))
            return ("sym", (name,), inv)
        if kind == "{":
            take("{")
            names, inv = [], False
            while peek() not in ("}", None):
                if peek() in (",", "|"):
                    take(peek())
                    continue
                name, i = _label(take("word"))
                names.append(name)
                inv = inv or i
            take("}")
            return ("sym", tuple(names), inv)
        raise ValueError(f"unexpected token {kind!r} at {pos} of {text!r}")

    tree = alternation()
    if pos != len(toks):
        raise ValueError(f"trailing tokens at {pos} of {text!r}")
    return tree


def label_names(tree) -> set[str]:
    """The distinct label names the query mentions (a wildcard none)."""
    if tree[0] == "sym":
        return set(tree[1] or ())
    if tree[0] in ("cat", "alt"):
        return set().union(*(label_names(p) for p in tree[1]))
    return label_names(tree[1])


def has_wildcard(tree) -> bool:
    if tree[0] == "sym":
        return tree[1] is None
    if tree[0] in ("cat", "alt"):
        return any(has_wildcard(p) for p in tree[1])
    return has_wildcard(tree[1])
