"""Query automata for RPQ / RPQI processing.

Port of ``repro/core/automaton.py``: a verbatim copy (only the import of
the regex module points at ``repro_torch.core.regex``), kept here so that
``repro_torch`` imports nothing of ``repro``.

``build_nfa`` compiles a parsed regex AST (:mod:`repro.core.regex`) into a
Thompson NFA, then eliminates epsilon transitions.  The result is a small
NFA (O(m) states, paper §2.7) whose transitions carry *symbols* over the
extended alphabet Δ' of Definition 3:

    symbol = (label_name, direction)   direction ∈ {FWD, INV}
    or the wildcard symbol (ANY, FWD) matching every forward label.

``CompiledAutomaton`` grounds the NFA against a concrete label vocabulary
(integer label ids) and precomputes, for every transition, the integer
label id and direction — the form consumed by the JAX product-automaton
in :mod:`repro.core.paa` and by the Pallas frontier kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.core import regex as rx

FWD = 0
INV = 1
ANY = "\x00any"  # wildcard pseudo-label


@dataclasses.dataclass(frozen=True)
class Transition:
    src: int
    label: str  # label name, or ANY for wildcard
    direction: int  # FWD or INV
    dst: int


@dataclasses.dataclass(frozen=True)
class NFA:
    n_states: int
    start: int
    accepting: frozenset[int]
    transitions: tuple[Transition, ...]

    @property
    def start_is_accepting(self) -> bool:
        return self.start in self.accepting

    def out_labels(self, state: int) -> set[tuple[str, int]]:
        """Distinct (label, direction) pairs on transitions out of ``state``.

        This is what S2 broadcasts per visited product-state (paper §4.2.2:
        'the broadcast query indicates the current node and the labels of
        the potential outgoing edges')."""
        return {(t.label, t.direction) for t in self.transitions if t.src == state}


# ---------------------------------------------------------------------------
# Thompson construction (with epsilon transitions), then closure-elimination
# ---------------------------------------------------------------------------


class _Builder:
    def __init__(self) -> None:
        self.n = 0
        self.eps: list[tuple[int, int]] = []
        self.sym: list[tuple[int, str, int, int]] = []  # (src, label, dir, dst)

    def new_state(self) -> int:
        self.n += 1
        return self.n - 1

    def add_eps(self, a: int, b: int) -> None:
        self.eps.append((a, b))

    def add_sym(self, a: int, label: str, direction: int, b: int) -> None:
        self.sym.append((a, label, direction, b))

    def build(self, node: rx.Node) -> tuple[int, int]:
        """Returns (in_state, out_state) of the fragment for ``node``."""
        if isinstance(node, rx.Label):
            a, b = self.new_state(), self.new_state()
            self.add_sym(a, node.name, INV if node.inverse else FWD, b)
            return a, b
        if isinstance(node, rx.Wildcard):
            a, b = self.new_state(), self.new_state()
            self.add_sym(a, ANY, INV if node.inverse else FWD, b)
            return a, b
        if isinstance(node, rx.LabelClass):
            a, b = self.new_state(), self.new_state()
            for name in node.names:
                self.add_sym(a, name, INV if node.inverse else FWD, b)
            return a, b
        if isinstance(node, rx.Concat):
            first_in, cur_out = self.build(node.parts[0])
            for part in node.parts[1:]:
                nin, nout = self.build(part)
                self.add_eps(cur_out, nin)
                cur_out = nout
            return first_in, cur_out
        if isinstance(node, rx.Union):
            a, b = self.new_state(), self.new_state()
            for part in node.parts:
                pin, pout = self.build(part)
                self.add_eps(a, pin)
                self.add_eps(pout, b)
            return a, b
        if isinstance(node, rx.Star):
            a, b = self.new_state(), self.new_state()
            pin, pout = self.build(node.inner)
            self.add_eps(a, pin)
            self.add_eps(pout, b)
            self.add_eps(a, b)
            self.add_eps(pout, pin)
            return a, b
        if isinstance(node, rx.Plus):
            pin, pout = self.build(node.inner)
            self.add_eps(pout, pin)
            return pin, pout
        if isinstance(node, rx.Optional_):
            a, b = self.new_state(), self.new_state()
            pin, pout = self.build(node.inner)
            self.add_eps(a, pin)
            self.add_eps(pout, b)
            self.add_eps(a, b)
            return a, b
        raise TypeError(node)


def _eps_closure(n: int, eps: list[tuple[int, int]]) -> list[set[int]]:
    adj: list[list[int]] = [[] for _ in range(n)]
    for a, b in eps:
        adj[a].append(b)
    closures: list[set[int]] = []
    for s in range(n):
        seen = {s}
        stack = [s]
        while stack:
            u = stack.pop()
            for v in adj[u]:
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        closures.append(seen)
    return closures


def build_nfa(node: rx.Node | str) -> NFA:
    """Compile an AST (or regex source string) into an epsilon-free NFA.

    States are renumbered to only those reachable from the start; the
    construction keeps O(m) states per the paper's complexity analysis."""
    if isinstance(node, str):
        node = rx.parse(node)
    builder = _Builder()
    start, final = builder.build(node)
    closures = _eps_closure(builder.n, builder.eps)

    # symbol transitions grouped by source for closure rewrite
    by_src: list[list[tuple[str, int, int]]] = [[] for _ in range(builder.n)]
    for a, label, direction, b in builder.sym:
        by_src[a].append((label, direction, b))

    # eps-free transitions: q --sym--> r  iff  exists p in closure(q) with p --sym--> r
    raw_trans: set[tuple[int, str, int, int]] = set()
    accepting_raw: set[int] = set()
    for q in range(builder.n):
        if final in closures[q]:
            accepting_raw.add(q)
        for p in closures[q]:
            for label, direction, r in by_src[p]:
                raw_trans.add((q, label, direction, r))

    # keep states reachable from start via symbol transitions
    reach = {start}
    frontier = [start]
    out_by_src: dict[int, list[tuple[int, str, int, int]]] = {}
    for t in raw_trans:
        out_by_src.setdefault(t[0], []).append(t)
    while frontier:
        u = frontier.pop()
        for (_, _, _, r) in out_by_src.get(u, []):
            if r not in reach:
                reach.add(r)
                frontier.append(r)

    remap = {old: new for new, old in enumerate(sorted(reach))}
    transitions = tuple(
        sorted(
            (
                Transition(remap[a], label, direction, remap[b])
                for (a, label, direction, b) in raw_trans
                if a in reach and b in reach
            ),
            key=lambda t: (t.src, t.label, t.direction, t.dst),
        )
    )
    accepting = frozenset(remap[q] for q in accepting_raw if q in reach)
    return NFA(
        n_states=len(reach),
        start=remap[start],
        accepting=accepting,
        transitions=transitions,
    )


# ---------------------------------------------------------------------------
# Grounding against a label vocabulary (integer ids) for the JAX PAA
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GroundedTransition:
    src: int
    label_id: int  # -1 means wildcard (all labels)
    direction: int
    dst: int


@dataclasses.dataclass(frozen=True)
class CompiledAutomaton:
    """NFA grounded against a graph's label vocabulary.

    Transitions whose label does not occur in the vocabulary are dropped
    (they can never fire).  ``transitions`` is the static, trace-time
    structure the jitted PAA frontier loop unrolls over.
    """

    nfa: NFA
    n_states: int
    start: int
    accepting: tuple[int, ...]
    transitions: tuple[GroundedTransition, ...]
    n_labels: int

    @property
    def uses_inverse(self) -> bool:
        return any(t.direction == INV for t in self.transitions)

    def out_degree_symbols(self, state: int) -> int:
        """Number of distinct (label, dir) symbols leaving ``state`` —
        the per-product-state broadcast payload size for S2 (§4.2.2),
        wildcards counting 1 symbol (the wildcard itself is broadcast)."""
        return len(self.nfa.out_labels(state))


def ground(nfa: NFA, label_to_id: Mapping[str, int]) -> CompiledAutomaton:
    grounded: list[GroundedTransition] = []
    for t in nfa.transitions:
        if t.label == ANY:
            grounded.append(GroundedTransition(t.src, -1, t.direction, t.dst))
        elif t.label in label_to_id:
            grounded.append(
                GroundedTransition(t.src, label_to_id[t.label], t.direction, t.dst)
            )
        # else: label absent from the data graph — transition can never fire
    return CompiledAutomaton(
        nfa=nfa,
        n_states=nfa.n_states,
        start=nfa.start,
        accepting=tuple(sorted(nfa.accepting)),
        transitions=tuple(grounded),
        n_labels=len(label_to_id),
    )
