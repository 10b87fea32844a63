"""The product BFS of the reference, many starts at once, and the §4.2
cost meters of each start.

The starts are bits: a state's visited set is a (V, W) array of uint64
words, bit ``b`` of word ``b // 64`` for start ``b``.  A level moves each
automaton move's frontier across the edges of its label, in its
direction, and ORs what arrives at a node (``np.bitwise_or.reduceat``
over the edges sorted by the node they reach).  The BFS runs to its
fixpoint.

The meters of one start, on the automaton of :mod:`.automaton` (§4.2.2):
a broadcast for each distinct (out-symbol set, node) among the product
states the start visits, of ``1 + |symbols|`` symbols, answered by 3
symbols for each edge at that node that matches one of the symbols.
``broadcast_symbols`` is the sum of the payloads, ``unicast_symbols`` of
the answers, ``n_broadcasts`` the count.
"""

from __future__ import annotations

import numpy as np

from rpqbench.reference import automaton as am
from rpqbench.reference import regex

EDGE_SYMBOLS = 3


class Index:
    """The graph's edges by (label, direction), sorted by the node they
    reach, and each (label, direction)'s edge count at every node.
    Label ``-1`` is every edge (the wildcard)."""

    def __init__(self, n_nodes: int, src: np.ndarray, lbl: np.ndarray, dst: np.ndarray, labels: list[str]):
        self.n_nodes = int(n_nodes)
        self.src = np.asarray(src, np.int64)
        self.lbl = np.asarray(lbl, np.int64)
        self.dst = np.asarray(dst, np.int64)
        self.labels = list(labels)
        self.label_ids = {name: i for i, name in enumerate(self.labels)}
        self.label_counts = np.bincount(self.lbl, minlength=len(self.labels))
        self._by_label = np.argsort(self.lbl, kind="stable")
        self._label_at = np.r_[0, np.cumsum(self.label_counts)]
        self._moves: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}
        self._degree: dict[tuple[int, int], np.ndarray] = {}

    def edges(self, label: int) -> np.ndarray:
        if label < 0:
            return np.arange(len(self.src))
        return np.sort(self._by_label[self._label_at[label] : self._label_at[label + 1]])

    def moves(self, label: int, direction: int) -> tuple[np.ndarray, np.ndarray]:
        """(from, to) of the edges a move on (label, direction) crosses,
        sorted by ``to``."""
        key = (label, direction)
        if key not in self._moves:
            e = self.edges(label)
            frm, to = (self.src[e], self.dst[e]) if direction == am.FWD else (self.dst[e], self.src[e])
            order = np.argsort(to, kind="stable")
            self._moves[key] = (frm[order], to[order])
        return self._moves[key]

    def degree(self, label: int, direction: int) -> np.ndarray:
        """Edges on ``label`` at each node, as their source (forward) or
        their target (inverse): the answer to a broadcast there."""
        key = (label, direction)
        if key not in self._degree:
            e = self.edges(label)
            ends = self.src[e] if direction == am.FWD else self.dst[e]
            self._degree[key] = np.bincount(ends, minlength=self.n_nodes).astype(np.int64)
        return self._degree[key]


def compile_query(query: str, index: Index) -> am.Automaton:
    return am.build(regex.parse(query), index.label_ids)


def valid_starts(aut: am.Automaton, index: Index) -> np.ndarray:
    """Nodes with an edge that a move out of the start state can take:
    the paper's valid starting points (Table 2)."""
    ok = np.zeros(index.n_nodes, bool)
    for q, label, direction, _ in aut.moves:
        if q == aut.start:
            frm, _ = index.moves(label, direction)
            ok[frm] = True
    return np.flatnonzero(ok).astype(np.int32)


def start_bits(starts: np.ndarray, n_nodes: int) -> np.ndarray:
    """(V, W) uint64 with bit ``b`` set at node ``starts[b]``."""
    starts = np.asarray(starts, np.int64)
    words = max(1, -(-len(starts) // 64))
    bits = np.zeros((n_nodes, words), np.uint64)
    b = np.arange(len(starts))
    np.bitwise_or.at(bits, (starts, b // 64), np.uint64(1) << (b % 64).astype(np.uint64))
    return bits


def reach(aut: am.Automaton, index: Index, starts: np.ndarray) -> np.ndarray:
    """Visited product states from each start: (n_states, V, W) uint64."""
    v = index.n_nodes
    first = start_bits(starts, v)
    visited = np.zeros((aut.n_states, v, first.shape[1]), np.uint64)
    visited[aut.start] = first
    frontier = visited.copy()
    while True:
        live = [frontier[q].any(axis=1) for q in range(aut.n_states)]
        arrived = np.zeros_like(visited)
        for q, label, direction, r in aut.moves:
            if not live[q].any():
                continue
            frm, to = index.moves(label, direction)
            sel = np.flatnonzero(live[q][frm])
            if not len(sel):
                continue
            t = to[sel]
            heads = np.flatnonzero(np.r_[True, t[1:] != t[:-1]])
            arrived[r][t[heads]] |= np.bitwise_or.reduceat(frontier[q][frm[sel]], heads, axis=0)
        frontier = arrived & ~visited
        if not frontier.any():
            return visited
        visited |= frontier


def unpack(words: np.ndarray, n: int) -> np.ndarray:
    """(V, W) uint64 -> (V, n) bool: column ``b`` is start ``b``'s bit."""
    as_bytes = np.ascontiguousarray(words).view(np.uint8).reshape(words.shape[0], 8 * words.shape[1])
    return np.unpackbits(as_bytes, axis=1, bitorder="little")[:, :n].astype(bool)


def _bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bfloat16 (to nearest, ties to even), as float64."""
    f = np.asarray(x, np.float32)
    u = f.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def answers_and_meters(aut: am.Automaton, index: Index, starts: np.ndarray,
                       meter_dtype: str = "float64") -> tuple[list[np.ndarray], np.ndarray]:
    """Each start's answers (the sorted nodes reached in an accepting
    state) and its meters, a (B, 3) array of (broadcast_symbols,
    unicast_symbols, n_broadcasts).  ``meter_dtype="bfloat16"`` keeps
    the meters' sums in bfloat16: the control one precision below the
    program's float32."""
    starts = np.asarray(starts, np.int64)
    n = len(starts)
    if n == 0:
        return [], np.zeros((0, 3))
    visited = reach(aut, index, starts)
    acc = np.zeros(visited.shape[1:], np.uint64)
    for q in aut.accepting:
        acc |= visited[q]
    rows = np.flatnonzero(acc.any(axis=1))
    b, at = np.nonzero(unpack(acc[rows], n).T)  # by start, then by node
    answers = np.split(rows[at].astype(np.int64), np.cumsum(np.bincount(b, minlength=n))[:-1])
    rnd = _bf16 if meter_dtype == "bfloat16" else (lambda x: np.asarray(x, np.float64))
    meters = np.zeros((n, 3))
    for symbols, states in aut.groups():
        seen = np.zeros_like(acc)
        for q in states:
            seen |= visited[q]
        rows = np.flatnonzero(seen.any(axis=1))
        at = unpack(seen[rows], n).astype(np.float64)
        count = at.sum(axis=0)
        degree = sum(index.degree(label, direction)[rows] for label, direction in symbols)
        answered = EDGE_SYMBOLS * (degree.astype(np.float64) @ at)
        meters[:, 0] = rnd(meters[:, 0] + rnd((1 + len(symbols)) * count))
        meters[:, 1] = rnd(meters[:, 1] + rnd(answered))
        meters[:, 2] = rnd(meters[:, 2] + rnd(count))
    return answers, meters


def s1_meters(query: str, index: Index) -> np.ndarray:
    """S1's §4.2.1 meters of one request: a broadcast of the query's
    distinct labels, answered by every edge on them (every edge under a
    wildcard), 3 symbols each; one broadcast."""
    tree = regex.parse(query)
    names = regex.label_names(tree)
    if regex.has_wildcard(tree):
        edges = len(index.src)
    else:
        edges = int(sum(index.label_counts[index.label_ids[x]] for x in names if x in index.label_ids))
    return np.array([float(len(names)), float(EDGE_SYMBOLS * edges), 1.0])


def departures(aut: am.Automaton, index: Index, starts: np.ndarray) -> dict[tuple[int, int], np.ndarray]:
    """For each (label, direction) of a move: the nodes from which some
    start's BFS takes that move (bool over V)."""
    visited = reach(aut, index, starts)
    out: dict[tuple[int, int], np.ndarray] = {}
    for q, label, direction, _ in aut.moves:
        at = visited[q].any(axis=1)
        key = (label, direction)
        out[key] = out[key] | at if key in out else at
    return out
