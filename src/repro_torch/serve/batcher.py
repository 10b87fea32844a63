"""Micro-batching of admitted queries.

Port of ``repro/serve/batcher.py``, verbatim (pure Python and numpy).
On one device the batch ``multiple`` is the fused kernel's query stack:
``QPAD`` (8 f32 rows) or ``QPACK`` (256 lanes).

Two coalescing rules, one per strategy:

* **S2** — queries whose automata share a structural signature are
  concatenated into one batched ``s2_execute`` call.  Start batches are
  padded up to a *bucketed* size (powers of two times the batch
  multiple), so an executor sees O(log max_batch) distinct batch sizes,
  not O(distinct request sizes).

* **S1** — queries are bin-packed (first-fit-decreasing over label-mask
  cost — raw popcount, or the estimated per-label D_s1 when the caller
  passes sample label weights — with the arrival-order greedy as a
  never-worse floor) while
  the union of their label masks stays under a budget; each group
  retrieves its union subgraph with a single ``s1_collect`` gather and
  every member runs its local PAA on the label-filtered view.  One
  broadcast+gather round serves the whole group (the per-query *meter*
  still charges each query its own §4.2.1 cost — coalescing changes
  wall-clock, not the paper's symbol accounting).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np


def bucket_size(n: int, multiple: int = 1, max_batch: int = 1024) -> int:
    """Smallest ``multiple × 2^k`` ≥ n, capped at the largest multiple of
    ``multiple`` ≤ max(max_batch, multiple).

    ``multiple`` is the executor's query stack (``QPAD`` or ``QPACK``),
    so padded batches fill whole stacks; working in units of
    ``multiple`` (rather than demanding a power of two outright) keeps
    this total for any multiple, e.g. 3 buckets to 3, 6, 12, 24, ...
    """
    m = max(multiple, 1)
    cap = max(max_batch // m, 1) * m
    units = -(-min(n, cap) // m)  # ceil(min(n, cap) / m)
    b = 1
    while b < units:
        b *= 2
    return min(b * m, cap)


def lane_fill_target(max_batch: int, multiple: int = 1) -> int:
    """How many queued starts fill one executor call — the async
    batching lane's *fill* trigger (``repro_torch.serve.aio``).

    This is the largest admissible bucket (:func:`bucket_size` of
    ``max_batch``): once a signature lane holds this many starts, the
    padded batch is full and waiting out the rest of the window buys no
    amortization, so the lane flushes immediately."""
    return bucket_size(max_batch, multiple, max_batch)


def pad_starts(starts: np.ndarray, size: int) -> np.ndarray:
    """Pad a start batch to ``size`` by repeating the first entry; padded
    rows are computed and discarded (answers are per-row)."""
    starts = np.asarray(starts, np.int32)
    if len(starts) >= size:
        return starts[:size]
    pad = np.full(size - len(starts), starts[0] if len(starts) else 0, np.int32)
    return np.concatenate([starts, pad])


# ---------------------------------------------------------------------------
# S2 signature batching
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class S2Slice:
    """One request's slice of a batched execution."""

    item: Any
    lo: int
    hi: int


def group_by_signature(
    items: Sequence[Any], signature_fn: Callable[[Any], tuple]
) -> list[list[Any]]:
    """Stable-order grouping of requests by automaton signature."""
    groups: dict[tuple, list[Any]] = {}
    for it in items:
        groups.setdefault(signature_fn(it), []).append(it)
    return list(groups.values())


def run_s2_group(
    group: Sequence[Any],
    execute: Callable[[np.ndarray, Any], tuple],
    max_batch: int = 128,
    multiple: int = 1,
) -> dict[int, tuple[np.ndarray, list, int, np.ndarray | None]]:
    """Run one signature group's concatenated starts through ``execute``.

    ``execute(starts, exemplar_item) -> (answers, costs)`` — or
    ``(answers, costs, levels)`` under witness semantics, where
    ``levels`` is the per-start (n_states, n_nodes) discovery-level
    plane (see :mod:`repro_torch.core.witness`) — is called once per bucketed
    chunk; every item in the group shares an automaton, so the
    exemplar's compiled executor serves all of them.  Returns
    ``{id(item): (answer_rows, cost_rows, padded_batch, level_rows)}``
    with ``level_rows`` ``None`` for pairs-mode groups.
    """
    slices: list[S2Slice] = []
    all_starts: list[np.ndarray] = []
    off = 0
    for it in group:
        s = np.asarray(it.starts, np.int32)
        slices.append(S2Slice(it, off, off + len(s)))
        all_starts.append(s)
        off += len(s)
    starts = np.concatenate(all_starts) if all_starts else np.zeros(0, np.int32)

    acc_chunks: list[np.ndarray] = []
    cost_chunks: list[list] = []
    lev_chunks: list[np.ndarray] = []
    pad_sizes: list[int] = []
    # chunk by the largest admissible bucket so bucket_size never truncates
    chunk_cap = bucket_size(max_batch, multiple, max_batch)
    for lo in range(0, len(starts), chunk_cap):
        chunk = starts[lo : lo + chunk_cap]
        size = bucket_size(len(chunk), multiple, max_batch)
        padded = pad_starts(chunk, size)
        res = execute(padded, group[0])
        acc, costs = res[0], res[1]
        acc_chunks.append(np.asarray(acc)[: len(chunk)])
        cost_chunks.append(costs[: len(chunk)])
        if len(res) > 2 and res[2] is not None:
            lev_chunks.append(np.asarray(res[2])[: len(chunk)])
        pad_sizes.append(size)

    acc_all = np.concatenate(acc_chunks) if acc_chunks else np.zeros((0, 0), bool)
    costs_all = [c for chunk in cost_chunks for c in chunk]
    lev_all = np.concatenate(lev_chunks) if lev_chunks else None
    batch_of = np.zeros(len(starts), np.int32)
    pos = 0
    for size, chunk in zip(pad_sizes, acc_chunks):
        batch_of[pos : pos + len(chunk)] = size
        pos += len(chunk)

    out: dict[int, tuple[np.ndarray, list, int, np.ndarray | None]] = {}
    for sl in slices:
        batch = int(batch_of[sl.lo]) if sl.hi > sl.lo else 0
        out[id(sl.item)] = (
            acc_all[sl.lo : sl.hi],
            costs_all[sl.lo : sl.hi],
            batch,
            lev_all[sl.lo : sl.hi] if lev_all is not None else None,
        )
    return out


# ---------------------------------------------------------------------------
# S1 label-mask coalescing
# ---------------------------------------------------------------------------


def _mask_cost(mask: np.ndarray, weights: np.ndarray | None) -> float:
    """Bin size of a label mask: popcount, or the D_s1-weighted sum."""
    if weights is None:
        return float(mask.sum())
    return float(weights[mask].sum())


def _budget(max_union_labels: int, weights: np.ndarray | None) -> float:
    """The bin capacity in the active cost unit.

    Unweighted, it is the label-count budget itself.  Weighted, the
    budget converts to symbol units at the *mean* label weight, so
    ``max_union_labels`` keeps its meaning ("about this many
    average-cost labels per gather"): unions of rare labels may pack
    more labels than the raw count, unions of hot labels fewer — the
    gather payload, not the label count, is what the budget bounds."""
    if weights is None:
        return float(max_union_labels)
    mean_w = float(weights.mean())
    if mean_w <= 0:
        return float(max_union_labels)  # degenerate sample: all labels free
    return max_union_labels * mean_w


def coalesce_s1(
    items: Sequence[Any],
    max_union_labels: int,
    label_weights: np.ndarray | None = None,
) -> list[list[Any]]:
    """Size-aware grouping of S1 requests under a union-cost budget.

    ``items`` carry a ``label_mask`` (n_labels,) bool attribute; each
    group costs one broadcast + gather round sized by its union mask, so
    fewer groups = higher throughput.  First-fit-decreasing bin packing:
    big masks open bins first, small masks backfill whatever bin still
    fits their *union* (overlapping masks are free — the bin "size" is a
    union cost, not a sum).  An oversized wildcard-style query still
    gets its own group rather than being rejected.

    ``label_weights`` (n_labels,) switches the bin size from raw label
    popcount to the estimated per-label D_s1 — e.g. ``3 × label_counts``
    from the planner's sample (§5.2.2) — so the budget bounds the
    *gather payload*: two hot labels can cost more than a dozen rare
    ones.  The budget rescales to ``max_union_labels × mean(weight)``,
    keeping the unweighted semantics when all labels cost the same.

    Arrival-order greedy (under the same cost) is kept as a floor: if
    FFD ever packs worse (possible — union-cost bin packing has no FFD
    guarantee), the greedy grouping is returned, so throughput never
    regresses vs the pre-FFD batcher."""
    if label_weights is not None:
        label_weights = np.asarray(label_weights, float)
    ffd = _coalesce_ffd(items, max_union_labels, label_weights)
    greedy = _coalesce_greedy(items, max_union_labels, label_weights)
    return ffd if len(ffd) <= len(greedy) else greedy


def _coalesce_ffd(
    items: Sequence[Any],
    max_union_labels: int,
    weights: np.ndarray | None = None,
) -> list[list[Any]]:
    """First-fit-decreasing by mask cost; stable within equal costs."""
    budget = _budget(max_union_labels, weights)
    order = sorted(
        range(len(items)),
        key=lambda i: (-_mask_cost(np.asarray(items[i].label_mask, bool), weights), i),
    )
    groups: list[list[Any]] = []
    unions: list[np.ndarray] = []
    for i in order:
        mask = np.asarray(items[i].label_mask, bool)
        for gi, union in enumerate(unions):
            cand = union | mask
            if _mask_cost(cand, weights) <= budget:
                groups[gi].append(items[i])
                unions[gi] = cand
                break
        else:
            groups.append([items[i]])
            unions.append(mask.copy())
    return groups


def _coalesce_greedy(
    items: Sequence[Any],
    max_union_labels: int,
    weights: np.ndarray | None = None,
) -> list[list[Any]]:
    """Arrival-order greedy (the pre-FFD batcher): a request joins the
    current group while the union stays within budget."""
    budget = _budget(max_union_labels, weights)
    groups: list[list[Any]] = []
    union: np.ndarray | None = None
    cur: list[Any] = []
    for it in items:
        mask = np.asarray(it.label_mask, bool)
        if not cur:
            cur, union = [it], mask.copy()
            continue
        candidate = union | mask
        if _mask_cost(candidate, weights) <= budget:
            cur.append(it)
            union = candidate
        else:
            groups.append(cur)
            cur, union = [it], mask.copy()
    if cur:
        groups.append(cur)
    return groups


def union_mask(items: Sequence[Any]) -> np.ndarray:
    out = np.asarray(items[0].label_mask, bool).copy()
    for it in items[1:]:
        out |= np.asarray(it.label_mask, bool)
    return out
