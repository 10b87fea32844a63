"""Regular-path-query expression parser.

Port of ``repro/core/regex.py``: a verbatim copy, kept here so that
``repro_torch`` imports nothing of ``repro``.

Grammar (paper §2: regular expressions over the edge-label alphabet, plus
the RPQI ``inverse`` operator of §2.3):

    expr     := term ('|' term)*
    term     := factor+
    factor   := atom ('*' | '+' | '?')*
    atom     := label | label'^-1' | '.' | '(' expr ')' | '{' class '}'
    label    := bare word, or "quoted string"
    class    := comma/pipe-separated list of labels (a disjunction class,
                as in the paper's C/A/I/E/P groups)

Labels may carry the inverse marker ``^-1`` (paper notation ``a^{-1}``),
turning an atom into a reverse-direction traversal on the extended
alphabet Δ' (Definition 3).

The parser produces an AST; :mod:`repro.core.automaton` compiles the AST to
a Thompson NFA whose transitions are (state, symbol, state) with symbols
drawn from the *extended* alphabet: ``(label_id, direction)`` where
direction ∈ {+1, -1}.  ``.`` is the wildcard symbol matching any forward
label (paper §3.3 — wildcards defeat S1's label-based selection, which the
cost model must see).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Node:
    """Base class for RPQ regex AST nodes."""


@dataclasses.dataclass(frozen=True)
class Label(Node):
    name: str
    inverse: bool = False


@dataclasses.dataclass(frozen=True)
class Wildcard(Node):
    inverse: bool = False


@dataclasses.dataclass(frozen=True)
class LabelClass(Node):
    """A disjunction over plain labels (paper's C/A/I/E/P classes)."""

    names: tuple[str, ...]
    inverse: bool = False


@dataclasses.dataclass(frozen=True)
class Concat(Node):
    parts: tuple[Node, ...]


@dataclasses.dataclass(frozen=True)
class Union(Node):
    parts: tuple[Node, ...]


@dataclasses.dataclass(frozen=True)
class Star(Node):
    inner: Node


@dataclasses.dataclass(frozen=True)
class Plus(Node):
    inner: Node


@dataclasses.dataclass(frozen=True)
class Optional_(Node):
    inner: Node


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_PUNCT = set("()|*+?{}.,")


@dataclasses.dataclass(frozen=True)
class _Tok:
    kind: str  # 'label' | punct char
    text: str


def _tokenize(src: str) -> Iterator[_Tok]:
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c.isspace():
            i += 1
            continue
        if c in _PUNCT:
            yield _Tok(c, c)
            i += 1
            continue
        if c == '"':
            j = src.index('"', i + 1)
            name = src[i + 1 : j]
            i = j + 1
        else:
            j = i
            while j < n and not src[j].isspace() and src[j] not in _PUNCT and src[j] != '"':
                j += 1
            name = src[i:j]
            i = j
        inverse = False
        # inverse marker: ^-1 or ⁻¹ appended to the bare token
        for marker in ("^-1", "^{-1}", "⁻¹"):
            if name.endswith(marker):
                name = name[: -len(marker)]
                inverse = True
                break
        yield _Tok("label", name + ("\x00inv" if inverse else ""))


# ---------------------------------------------------------------------------
# Recursive-descent parser
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, toks: Sequence[_Tok]):
        self.toks = list(toks)
        self.pos = 0

    def peek(self) -> _Tok | None:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> _Tok:
        tok = self.toks[self.pos]
        self.pos += 1
        return tok

    def expect(self, kind: str) -> _Tok:
        tok = self.peek()
        if tok is None or tok.kind != kind:
            raise ValueError(f"expected {kind!r} at token {self.pos}, got {tok}")
        return self.next()

    # expr := term ('|' term)*
    def parse_expr(self) -> Node:
        parts = [self.parse_term()]
        while (t := self.peek()) is not None and t.kind == "|":
            self.next()
            parts.append(self.parse_term())
        return parts[0] if len(parts) == 1 else Union(tuple(parts))

    # term := factor+
    def parse_term(self) -> Node:
        parts = []
        while (t := self.peek()) is not None and t.kind not in ("|", ")", "}"):
            parts.append(self.parse_factor())
        if not parts:
            raise ValueError("empty term in regex")
        return parts[0] if len(parts) == 1 else Concat(tuple(parts))

    # factor := atom ('*'|'+'|'?')*
    def parse_factor(self) -> Node:
        node = self.parse_atom()
        while (t := self.peek()) is not None and t.kind in ("*", "+", "?"):
            self.next()
            node = {"*": Star, "+": Plus, "?": Optional_}[t.kind](node)
        return node

    def parse_atom(self) -> Node:
        tok = self.peek()
        if tok is None:
            raise ValueError("unexpected end of regex")
        if tok.kind == "(":
            self.next()
            inner = self.parse_expr()
            self.expect(")")
            return inner
        if tok.kind == "{":
            self.next()
            names: list[str] = []
            inverse = False
            while (t := self.peek()) is not None and t.kind != "}":
                if t.kind in (",", "|"):
                    self.next()
                    continue
                if t.kind != "label":
                    raise ValueError(f"bad token in label class: {t}")
                name = self.next().text
                if name.endswith("\x00inv"):
                    name = name[: -len("\x00inv")]
                    inverse = True
                names.append(name)
            self.expect("}")
            return LabelClass(tuple(names), inverse=inverse)
        if tok.kind == ".":
            self.next()
            return Wildcard()
        if tok.kind == "label":
            name = self.next().text
            inverse = name.endswith("\x00inv")
            if inverse:
                name = name[: -len("\x00inv")]
            return Label(name, inverse=inverse)
        raise ValueError(f"unexpected token {tok}")


def parse(src: str) -> Node:
    """Parse an RPQ regular expression into an AST."""
    parser = _Parser(list(_tokenize(src)))
    node = parser.parse_expr()
    if parser.pos != len(parser.toks):
        raise ValueError(f"trailing tokens in regex at {parser.pos}")
    return node


# ---------------------------------------------------------------------------
# Introspection used by the cost model
# ---------------------------------------------------------------------------


def labels_of(node: Node) -> set[str]:
    """Distinct labels appearing in the query — the paper's Q_lbl(q) counts
    ``len(labels_of(ast))`` (§4.4: 'the number of distinct labels in a query')."""
    if isinstance(node, Label):
        return {node.name}
    if isinstance(node, LabelClass):
        return set(node.names)
    if isinstance(node, Wildcard):
        return set()
    if isinstance(node, (Concat, Union)):
        out: set[str] = set()
        for p in node.parts:
            out |= labels_of(p)
        return out
    if isinstance(node, (Star, Plus, Optional_)):
        return labels_of(node.inner)
    raise TypeError(node)


def has_wildcard(node: Node) -> bool:
    """True if the query contains '.', defeating S1's label selection (§3.6)."""
    if isinstance(node, Wildcard):
        return True
    if isinstance(node, (Concat, Union)):
        return any(has_wildcard(p) for p in node.parts)
    if isinstance(node, (Star, Plus, Optional_)):
        return has_wildcard(node.inner)
    return False


def query_size(node: Node) -> int:
    """The paper's m: number of characters/operators in the expression (§2.7)."""
    if isinstance(node, (Label, Wildcard)):
        return 1
    if isinstance(node, LabelClass):
        return len(node.names)
    if isinstance(node, Concat):
        return sum(query_size(p) for p in node.parts)
    if isinstance(node, Union):
        return sum(query_size(p) for p in node.parts) + len(node.parts) - 1
    if isinstance(node, (Star, Plus, Optional_)):
        return query_size(node.inner) + 1
    raise TypeError(node)
