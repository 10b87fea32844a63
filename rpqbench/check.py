"""The comparison that decides ``correct``: the served answers and §4.2
meters of the window's requests against the reference's.

Each served request gives (query, starts, strategy, per-start answer
sets, observed meters).  The reference works every answer and meter out
again from the graph alone (:mod:`rpqbench.reference.bfs`): an S2
request's meters per start, an S1 request's one §4.2.1 cost.  Three
numbers are compared, each with its limit (the configuration's
``limits``):

* ``answers_wrong`` — (start, node) pairs in one answer set and not the
  other, over the compared requests (limit 0);
* ``malformed`` — requests whose strategy is neither S1 nor S2, or
  whose answers or meters do not have one entry per start (S2) or one
  (S1) (limit 0);
* ``meters_gap`` — the widest relative gap of a meter
  (``broadcast_symbols``, ``unicast_symbols``, ``n_broadcasts``),
  |served − reference| / max(reference, 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rpqbench.reference import bfs


@dataclasses.dataclass
class Served:
    query: str
    starts: np.ndarray
    strategy: str
    answers: list  # one set of nodes a start
    meters: np.ndarray  # (len(observed), 3): broadcast, unicast, broadcasts


def from_answers(query: str, starts, a) -> Served:
    """A resolved ``Answers`` of the port, as the comparison reads it."""
    meters = np.array([[c.broadcast_symbols, c.unicast_symbols, c.n_broadcasts] for c in a.observed],
                      np.float64).reshape(-1, 3)
    return Served(query, np.asarray(starts), a.strategy, [set(s) for s in a.answers], meters)


def reference_results(items: list[tuple[str, np.ndarray]], index: bfs.Index,
                      meter_dtype: str = "float64") -> dict[tuple[str, int], tuple[np.ndarray, np.ndarray]]:
    """(query, start) -> (answers, S2 meters) for every start of ``items``,
    one multi-source BFS a query."""
    starts: dict[str, set] = {}
    for q, s in items:
        starts.setdefault(q, set()).update(np.asarray(s).tolist())
    out = {}
    for q, ss in starts.items():
        ss = np.array(sorted(ss), np.int64)
        answers, meters = bfs.answers_and_meters(bfs.compile_query(q, index), index, ss, meter_dtype)
        out.update({(q, int(v)): (a, m) for v, a, m in zip(ss, answers, meters)})
    return out


def judge(served: list[Served], index: bfs.Index, limits: dict) -> dict[str, dict]:
    """Each compared number beside its limit."""
    ref = reference_results([(r.query, r.starts) for r in served], index)
    wrong = malformed = 0
    gap = 0.0
    for r in served:
        n = len(r.starts)
        want_meters = n if r.strategy == "S2" else 1
        if r.strategy not in ("S1", "S2") or len(r.answers) != n or len(r.meters) != want_meters:
            malformed += 1
            continue
        for v, got in zip(r.starts.tolist(), r.answers):
            want = ref[(r.query, int(v))][0]
            wrong += len(got.symmetric_difference(want.tolist()))
        if r.strategy == "S2":
            expect = np.stack([ref[(r.query, int(v))][1] for v in r.starts.tolist()]) if n else np.zeros((0, 3))
        else:
            expect = bfs.s1_meters(r.query, index)[None]
        if len(expect):
            gap = max(gap, float(np.max(np.abs(r.meters - expect) / np.maximum(np.abs(expect), 1.0))))
    return {
        "answers_wrong": {"value": wrong, "limit": limits["answers_wrong"]},
        "malformed": {"value": malformed, "limit": limits["malformed"]},
        "meters_gap": {"value": gap, "limit": limits["meters_gap"]},
    }


def passed(checks: dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def control(items: list[tuple[str, np.ndarray]], index: bfs.Index) -> list[Served]:
    """The reference put in the program's place, its meters summed in
    bfloat16, one precision below the program's float32: what it would
    have served for ``items``."""
    ref = reference_results(items, index, "bfloat16")
    out = []
    for q, s in items:
        rows = [ref[(q, int(v))] for v in np.asarray(s).tolist()]
        meters = np.stack([m for _, m in rows]) if rows else np.zeros((0, 3))
        out.append(Served(q, np.asarray(s), "S2", [set(a.tolist()) for a, _ in rows], meters))
    return out
