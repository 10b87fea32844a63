"""The least device time of an S2 call, from the graph and the
reference's BFS: what the call's queries need, not what the program
launches.

An adjacency tile is ``block`` × ``block`` nodes of one label, held as
bits.  A call needs each tile that some start's BFS leaves from (a
visited product state at one of the tile's source nodes, or its target
nodes for an inverse move, with a move on the tile's label) read once,
its starts read once (int32) and one answer row a start written once
(bits).  Its least time is those bytes at the card's memory bandwidth
(``peaks.json``)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from rpqbench.reference import automaton as am
from rpqbench.reference import bfs

PEAKS = Path(__file__).with_name("peaks.json")


def peak(kind: str, key: str) -> float:
    """The card's published peak ``key`` (``hbm_bytes_per_s``, ...)."""
    table = json.loads(PEAKS.read_text())
    if kind not in table:
        raise KeyError(f"no peaks for {kind!r} in {PEAKS}")
    return float(table[kind][key])


def least_bytes(aut: am.Automaton, index: bfs.Index, starts: np.ndarray, block: int) -> int:
    starts = np.unique(np.asarray(starts))
    nb = -(-index.n_nodes // block)
    keys = []
    for (label, direction), active in bfs.departures(aut, index, starts).items():
        e = index.edges(label)
        frm = index.src[e] if direction == am.FWD else index.dst[e]
        e = e[active[frm]]
        keys.append((index.lbl[e] * nb + index.src[e] // block) * nb + index.dst[e] // block)
    tiles = len(np.unique(np.concatenate(keys))) if keys else 0
    return tiles * block * block // 8 + len(starts) * (4 + -(-index.n_nodes // 8))
