"""The host graph of the frozen generators: edges (src, label id, dst)
over a label vocabulary, the fields of the port's ``LabeledGraph``."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Graph:
    n_nodes: int
    src: np.ndarray  # (E,) int32
    lbl: np.ndarray  # (E,) int32
    dst: np.ndarray  # (E,) int32
    labels: list[str]  # label id -> name

    def __post_init__(self) -> None:
        self.src = np.asarray(self.src, np.int32)
        self.lbl = np.asarray(self.lbl, np.int32)
        self.dst = np.asarray(self.dst, np.int32)

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def n_labels(self) -> int:
        return len(self.labels)

    def dedup(self) -> "Graph":
        """The distinct (src, lbl, dst) triples, in first-seen order."""
        key = (self.src.astype(np.int64) * self.n_labels + self.lbl) * self.n_nodes + self.dst
        _, idx = np.unique(key, return_index=True)
        idx = np.sort(idx)
        return Graph(self.n_nodes, self.src[idx], self.lbl[idx], self.dst[idx], self.labels)
