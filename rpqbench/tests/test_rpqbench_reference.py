"""The reference on the paper's example, on the Alibaba twin's Table-2
counts, and against a plain per-start BFS meter written here."""

import numpy as np
import pytest

from rpqbench import check
from rpqbench.data.generators import TABLE2_QUERIES, alibaba_like
from rpqbench.reference import bfs, regex

# The paper's Figure 1a graph (nodes 1..9 as 0..8), as the repo reconstructs it.
EXAMPLE = [(1, "a", 2), (2, "a", 6), (6, "a", 9), (9, "a", 2), (2, "a", 5), (3, "a", 5),
           (1, "b", 4), (4, "b", 5), (9, "b", 3), (3, "b", 8), (8, "b", 7), (7, "b", 6),
           (4, "c", 3), (2, "c", 3), (6, "c", 8)]


def example_index() -> bfs.Index:
    labels = ["a", "b", "c"]
    src = np.array([s - 1 for s, _, _ in EXAMPLE])
    lbl = np.array([labels.index(x) for _, x, _ in EXAMPLE])
    dst = np.array([d - 1 for _, _, d in EXAMPLE])
    return bfs.Index(9, src, lbl, dst, labels)


def answers(query: str, index: bfs.Index, starts) -> list[set[int]]:
    got, _ = bfs.answers_and_meters(bfs.compile_query(query, index), index, np.asarray(starts))
    return [set((a + 1).tolist()) for a in got]


@pytest.mark.parametrize("query, start, want", [
    ("a* b b", 1, {5, 8}),
    ("a* b^-1", 1, {4, 7}),
])
def test_rpqbench_reference_example_single_source(query, start, want):
    assert answers(query, example_index(), [start - 1]) == [want]


def test_rpqbench_reference_example_pairs():
    ix = example_index()
    aut = bfs.compile_query("a c (a|b)", ix)
    starts = np.arange(9)
    got = {(s + 1, v) for s, ans in zip(starts, answers("a c (a|b)", ix, starts)) for v in ans}
    assert got == {(1, 5), (9, 5), (1, 8), (9, 8), (2, 7)}
    assert set((bfs.valid_starts(aut, ix) + 1).tolist()) == {1, 2, 3, 6, 9}


@pytest.mark.parametrize("text, tree", [
    ("a b", ("cat", (("sym", ("a",), False), ("sym", ("b",), False)))),
    ("(a|b)*", ("star", ("alt", (("sym", ("a",), False), ("sym", ("b",), False))))),
    ("{x, y^-1}+ .", ("cat", (("plus", ("sym", ("x", "y"), True)), ("sym", None, False)))),
    ('"up-regulation" c?', ("cat", (("sym", ("up-regulation",), False), ("opt", ("sym", ("c",), False))))),
])
def test_rpqbench_reference_parse(text, tree):
    assert regex.parse(text) == tree


@pytest.fixture(scope="module")
def twin():
    g = alibaba_like(seed=0)
    return g, bfs.Index(g.n_nodes, g.src, g.lbl, g.dst, g.labels)


@pytest.mark.parametrize("q, pairs, starts", [("q1", 1075, 477), ("q9", 66897, 715), ("q12", 31695, 715)])
def test_rpqbench_reference_twin_table2(twin, q, pairs, starts):
    g, ix = twin
    assert (g.n_nodes, g.n_edges, g.n_labels) == (50000, 327848, 216)
    aut = bfs.compile_query(TABLE2_QUERIES[q], ix)
    vs = bfs.valid_starts(aut, ix)
    got, meters = bfs.answers_and_meters(aut, ix, vs)
    assert (len(vs), sum(len(a) for a in got)) == (starts, pairs)
    assert meters.shape == (starts, 3) and (meters[:, 2] > 0).all()


def plain_meters(aut, ix: bfs.Index, start: int) -> tuple[set[int], tuple[float, float, float]]:
    """One start's answers and §4.2.2 meters by a plain queue BFS over
    product states, a broadcast per distinct (symbol set, node)."""
    seen, todo, asked = {(aut.start, start)}, [(aut.start, start)], set()
    q_bc = d_s2 = n_bc = 0
    while todo:
        q, v = todo.pop()
        syms = aut.symbols(q)
        if syms and (syms, v) not in asked:
            asked.add((syms, v))
            n_bc += 1
            q_bc += 1 + len(syms)
            d_s2 += 3 * sum(int(ix.degree(l, d)[v]) for l, d in syms)
        for q0, label, direction, r in aut.moves:
            if q0 != q:
                continue
            for e in range(len(ix.src)):
                if label >= 0 and ix.lbl[e] != label:
                    continue
                frm, to = (ix.src[e], ix.dst[e]) if direction == 0 else (ix.dst[e], ix.src[e])
                if frm == v and (r, int(to)) not in seen:
                    seen.add((r, int(to)))
                    todo.append((r, int(to)))
    acc = {v for q, v in seen if q in aut.accepting}
    return acc, (float(q_bc), float(d_s2), float(n_bc))


@pytest.mark.parametrize("query", ["l0 l1+", "(l0|l2)* l1^-1", ". l3", "{l1, l2}+ (l0)?", "l4"])
def test_rpqbench_reference_meters_against_plain_bfs(query):
    rng = np.random.default_rng(7)
    n, e = 40, 160
    ix = bfs.Index(n, rng.integers(0, n, e), rng.integers(0, 4, e), rng.integers(0, n, e),
                   ["l0", "l1", "l2", "l3"])
    aut = bfs.compile_query(query, ix)
    starts = np.arange(n)
    got, meters = bfs.answers_and_meters(aut, ix, starts)
    for s in starts:
        acc, want = plain_meters(aut, ix, int(s))
        assert set(got[s].tolist()) == acc
        assert tuple(meters[s]) == want


def test_rpqbench_reference_bfloat16_meters_round(twin):
    _, ix = twin
    aut = bfs.compile_query(TABLE2_QUERIES["q12"], ix)
    vs = bfs.valid_starts(aut, ix)[:64]
    _, exact = bfs.answers_and_meters(aut, ix, vs)
    _, low = bfs.answers_and_meters(aut, ix, vs, "bfloat16")
    gap = np.abs(low - exact) / np.maximum(exact, 1)
    assert 0 < gap.max() < 2.0**-6  # a few roundings of 2^-9 each


def test_rpqbench_reference_s1_meters(twin):
    _, ix = twin
    m = bfs.s1_meters("acetylation {activation|activity}", ix)
    counts = ix.label_counts[[ix.label_ids[x] for x in ("acetylation", "activation", "activity")]]
    assert tuple(m) == (3.0, 3.0 * counts.sum(), 1.0)
    assert bfs.s1_meters(". acetylation", ix)[1] == 3.0 * len(ix.src)


def test_rpqbench_reference_judge_counts_faults(twin):
    _, ix = twin
    q = TABLE2_QUERIES["q1"]
    starts = bfs.valid_starts(bfs.compile_query(q, ix), ix)[:16]
    limits = {"answers_wrong": 0, "malformed": 0, "meters_gap": 1e-5}
    good = check.control([(q, starts)], ix)
    _, exact = bfs.answers_and_meters(bfs.compile_query(q, ix), ix, starts)
    good[0].meters = exact
    assert check.passed(check.judge(good, ix, limits))
    good[0].answers[3].add(12345)
    assert check.judge(good, ix, limits)["answers_wrong"]["value"] == 1
    good[0].answers.pop()
    assert check.judge(good, ix, limits)["malformed"]["value"] == 1
