"""The query automaton of the reference: Thompson's construction, its
ε-moves removed, grounded against the graph's label ids.

The §4.2 meters are defined on this automaton (a broadcast per visited
(symbol set, node)), so it is built by the paper's construction: a
fragment per node of the tree, ε-closure, every state that a symbol
reaches from the start kept.  A symbol is (label id, direction), label
id ``-1`` for the wildcard; a label the vocabulary lacks never fires.
"""

from __future__ import annotations

import dataclasses

FWD, INV = 0, 1


@dataclasses.dataclass(frozen=True)
class Automaton:
    n_states: int
    start: int
    accepting: frozenset[int]
    moves: tuple[tuple[int, int, int, int], ...]  # (from state, label id, direction, to state)

    def symbols(self, state: int) -> frozenset[tuple[int, int]]:
        return frozenset((l, d) for q, l, d, _ in self.moves if q == state)

    def groups(self) -> list[tuple[frozenset[tuple[int, int]], list[int]]]:
        """States by their nonempty out-symbol set: the broadcast key."""
        by: dict[frozenset, list[int]] = {}
        for q in range(self.n_states):
            s = self.symbols(q)
            if s:
                by.setdefault(s, []).append(q)
        return sorted(by.items(), key=lambda kv: sorted(kv[0]))


def build(tree, label_ids: dict[str, int]) -> Automaton:
    eps: list[tuple[int, int]] = []
    sym: list[tuple[int, object, int, int]] = []  # (a, names or None, dir, b)
    count = [0]

    def state() -> int:
        count[0] += 1
        return count[0] - 1

    def frag(node) -> tuple[int, int]:
        kind = node[0]
        if kind == "sym":
            a, b = state(), state()
            names, inv = node[1], node[2]
            sym.append((a, names, INV if inv else FWD, b))
            return a, b
        if kind == "cat":
            first, last = frag(node[1][0])
            for part in node[1][1:]:
                i, o = frag(part)
                eps.append((last, i))
                last = o
            return first, last
        if kind == "alt":
            a, b = state(), state()
            for part in node[1]:
                i, o = frag(part)
                eps.extend([(a, i), (o, b)])
            return a, b
        if kind == "plus":
            i, o = frag(node[1])
            eps.append((o, i))
            return i, o
        a, b = state(), state()  # star, opt
        i, o = frag(node[1])
        eps.extend([(a, i), (o, b), (a, b)])
        if kind == "star":
            eps.append((o, i))
        return a, b

    start, final = frag(tree)
    n = count[0]
    nxt = [[] for _ in range(n)]
    for a, b in eps:
        nxt[a].append(b)
    closure = []
    for s in range(n):
        seen, todo = {s}, [s]
        while todo:
            for v in nxt[todo.pop()]:
                if v not in seen:
                    seen.add(v)
                    todo.append(v)
        closure.append(seen)
    out = [[] for _ in range(n)]
    for a, names, d, b in sym:
        out[a].append((names, d, b))
    # an ε-free move q --x--> r for every p in closure(q) with p --x--> r
    moves = {(q, names, d, r) for q in range(n) for p in closure[q] for names, d, r in out[p]}
    keep, todo = {start}, [start]
    while todo:
        q = todo.pop()
        for q0, _, _, r in moves:
            if q0 == q and r not in keep:
                keep.add(r)
                todo.append(r)
    index = {q: i for i, q in enumerate(sorted(keep))}
    grounded = set()
    for q, names, d, r in moves:
        if q not in keep:
            continue
        if names is None:
            grounded.add((index[q], -1, d, index[r]))
        else:
            grounded.update((index[q], label_ids[x], d, index[r]) for x in names if x in label_ids)
    accepting = frozenset(index[q] for q in keep if final in closure[q])
    return Automaton(len(keep), index[start], accepting, tuple(sorted(grounded)))
