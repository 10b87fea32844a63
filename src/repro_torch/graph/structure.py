"""Edge-labeled directed graph structures (paper §2.1).

Port of ``repro/graph/structure.py``.  ``LabeledGraph`` and
``example_graph`` are verbatim numpy; ``DeviceGraph`` holds label-sorted
int64 torch tensors on one device plus the host ``label_offsets`` tuple.

``LabeledGraph`` is the host-side graph: numpy edge arrays plus a label
vocabulary and per-label edge groupings.  ``DeviceGraph`` is the
device-ready form used by the device PAA (:mod:`repro_torch.core.paa`):
edges sorted by label with a label-offset table (CSR-over-labels), so a
per-label slice is contiguous and the frontier loop's per-transition
gathers are cheap.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import torch

from repro_torch import resolve_device


@dataclasses.dataclass
class LabeledGraph:
    """Host graph: edges (src, label_id, dst) with a label vocabulary."""

    n_nodes: int
    src: np.ndarray  # (E,) int32
    lbl: np.ndarray  # (E,) int32
    dst: np.ndarray  # (E,) int32
    labels: list[str]  # label_id -> name

    def __post_init__(self) -> None:
        self.src = np.asarray(self.src, np.int32)
        self.lbl = np.asarray(self.lbl, np.int32)
        self.dst = np.asarray(self.dst, np.int32)
        assert self.src.shape == self.lbl.shape == self.dst.shape

    # -- basic stats ------------------------------------------------------
    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def n_labels(self) -> int:
        return len(self.labels)

    @property
    def label_to_id(self) -> dict[str, int]:
        return {name: i for i, name in enumerate(self.labels)}

    def label_counts(self) -> np.ndarray:
        """Edge count per label id — the label-frequency statistics used by
        S1's D_s1 estimate and by both statistical graph models (§5)."""
        return np.bincount(self.lbl, minlength=self.n_labels).astype(np.int64)

    def out_degree(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n_nodes).astype(np.int64)

    def in_degree(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.n_nodes).astype(np.int64)

    # -- per-label edge views ----------------------------------------------
    def edges_with_label(self, label_id: int) -> tuple[np.ndarray, np.ndarray]:
        mask = self.lbl == label_id
        return self.src[mask], self.dst[mask]

    def sorted_by_label(self) -> "LabeledGraph":
        order = np.argsort(self.lbl, kind="stable")
        return LabeledGraph(
            self.n_nodes, self.src[order], self.lbl[order], self.dst[order], self.labels
        )

    def dedup(self) -> "LabeledGraph":
        """Deduplicate (src,lbl,dst) triples — used when re-assembling data
        retrieved from replicated sites (replication factor K, §3.5.1)."""
        key = (self.src.astype(np.int64) * self.n_labels + self.lbl) * self.n_nodes + self.dst
        _, idx = np.unique(key, return_index=True)
        idx = np.sort(idx)
        return LabeledGraph(self.n_nodes, self.src[idx], self.lbl[idx], self.dst[idx], self.labels)

    def subgraph_with_labels(self, label_ids: set[int]) -> "LabeledGraph":
        """S1's retrieved working set: all edges whose label appears in the
        query (§3.3's label-based selection)."""
        mask = np.isin(self.lbl, sorted(label_ids))
        return LabeledGraph(self.n_nodes, self.src[mask], self.lbl[mask], self.dst[mask], self.labels)


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Device-resident, label-sorted graph with a label offset table.

    ``src``/``dst`` are sorted by label; ``label_offsets`` has length
    n_labels+1 so that label l's edges live at ``[label_offsets[l],
    label_offsets[l+1])``.  The offsets stay a host tuple, so per-label
    slices are plain views with no device read.  Edge arrays are int64,
    the index type of torch's gather and scatter.
    """

    n_nodes: int
    n_labels: int
    src: torch.Tensor  # (E,) int64, label-sorted
    dst: torch.Tensor  # (E,) int64, label-sorted
    lbl: torch.Tensor  # (E,) int64, sorted
    label_offsets: tuple[int, ...]  # (n_labels+1,) host-side

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device

    def label_slice(self, label_id: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Contiguous (src, dst) views for one label."""
        lo, hi = self.label_offsets[label_id], self.label_offsets[label_id + 1]
        return self.src[lo:hi], self.dst[lo:hi]


def to_device_graph(
    graph: LabeledGraph, device: str | torch.device | None = None
) -> DeviceGraph:
    """Label-sort ``graph`` and move it to ``device`` (``None``: the GPU)."""
    device = resolve_device(device)
    ordered = graph.sorted_by_label()
    counts = ordered.label_counts()
    offsets = np.zeros(graph.n_labels + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.astype(np.int64)).to(device)

    return DeviceGraph(
        n_nodes=graph.n_nodes,
        n_labels=graph.n_labels,
        src=put(ordered.src),
        dst=put(ordered.dst),
        lbl=put(ordered.lbl),
        label_offsets=tuple(int(o) for o in offsets),
    )


def example_graph() -> LabeledGraph:
    """The paper's Figure 1a example graph (9 nodes, labels a/b/c).

    The figure itself is not machine-readable; the edge set below is the
    unique-up-to-the-examples reconstruction satisfying every worked answer
    in §2.4 and the label-frequency statement of §2.8 (a ×6, b ×6, c ×3,
    c-edges exactly {4-3, 2-3, 6-8}):

      Q1  = (1, a*bb)      -> {5 (1-4-5, bb), 8 (1-2-6-9-3-8, aaabb)}
      Q2  = ac(a|b)        -> {(1,5),(9,5),(1,8),(9,8),(2,7)}
      QI3 = (1, a*b^-1)    -> {4 (1-2-5-4), 7 (1-2-6-7)}
      cycle 2-6-9-2 present.

    Nodes 1..9 are mapped to ids 0..8.
    """
    edges = [
        # a-edges (6)
        (1, "a", 2),
        (2, "a", 6),
        (6, "a", 9),
        (9, "a", 2),  # closes the 2-6-9-2 cycle
        (2, "a", 5),  # QI3 path 1-2-5-4 needs 2 -a-> 5
        (3, "a", 5),  # Q2 aca: ...-c-> 3 -a-> 5
        # b-edges (6)
        (1, "b", 4),
        (4, "b", 5),
        (9, "b", 3),
        (3, "b", 8),
        (8, "b", 7),  # Q2 acb: 2-a->6-c->8-b->7
        (7, "b", 6),  # QI3 path 1-2-6-7 (b traversed inverse)
        # c-edges (3) — §2.8: "the edges 4-3, 2-3, and 6-8"
        (4, "c", 3),
        (2, "c", 3),
        (6, "c", 8),
    ]
    labels = ["a", "b", "c"]
    lmap = {n: i for i, n in enumerate(labels)}
    src = np.array([e[0] - 1 for e in edges], np.int32)
    lbl = np.array([lmap[e[1]] for e in edges], np.int32)
    dst = np.array([e[2] - 1 for e in edges], np.int32)
    return LabeledGraph(9, src, lbl, dst, labels)
