"""The Alibaba twin and the paper's Table-2 queries, frozen.

A copy of the port's ``graph/generators.py`` (``alibaba_like``,
``TABLE2_QUERIES`` and the label classes) as it stood when the benchmark
was defined, so that the yardstick's inputs do not move with the
program.  ``rpqbench/tests/test_rpqbench_data.py`` holds it to the
port's function array for array.  The graph is a :class:`~rpqbench.data.graph.Graph`,
which the harness hands to the port's own ``LabeledGraph``.
"""

from __future__ import annotations

import numpy as np

from rpqbench.data.graph import Graph

# The paper's Table-2 label classes.
C_LABELS = [
    "interaction", "interactions", "binding", "complex",
    "interacting", "complexes", "interacts",
]
A_LABELS = [
    "activation", "activity", "production", "induction", "overexpression",
    "up-regulation", "induces", "activates", "increases",
]
I_LABELS = ["down-regulation", "inhibits", "inhibited", "inhibitor", "inhibition"]
E_LABELS = ["expression", "overexpression", "regulates", "up-regulation", "expressing"]
P_LABELS = [
    "dephosphorylates", "dephosphorylated", "dephosphorylate", "dephosphorylation",
    "phosphorylates", "phosphorylated", "phosphorylate", "phosphorylation",
]
RARE_LABELS = ["acetylation", "methylation", "fusions", "receptor"]

CLASS_EXPR = {
    "C": "{" + "|".join(C_LABELS) + "}",
    "A": "{" + "|".join(A_LABELS) + "}",
    "I": "{" + "|".join(I_LABELS) + "}",
    "E": "{" + "|".join(E_LABELS) + "}",
    "P": "{" + "|".join(P_LABELS) + "}",
}

# Table 2 queries, written in this framework's regex syntax.
TABLE2_QUERIES = {
    "q1": f'{CLASS_EXPR["C"]}+ acetylation {CLASS_EXPR["A"]}+',
    "q2": f'{CLASS_EXPR["C"]}+ acetylation {CLASS_EXPR["I"]}+',
    "q3": f'{CLASS_EXPR["C"]}+ methylation {CLASS_EXPR["A"]}+',
    "q4": f'{CLASS_EXPR["C"]}+ methylation {CLASS_EXPR["I"]}+',
    "q5": f'{CLASS_EXPR["C"]}+ fusions {CLASS_EXPR["P"]}',
    "q6": f'fusions {CLASS_EXPR["A"]}+',
    "q7": f'{CLASS_EXPR["A"]}+ receptor {CLASS_EXPR["P"]}',
    "q8": f'{CLASS_EXPR["I"]}+ receptor {CLASS_EXPR["P"]}',
    "q9": f'{CLASS_EXPR["A"]} {CLASS_EXPR["A"]}+',
    "q10": f'{CLASS_EXPR["I"]} {CLASS_EXPR["I"]}+',
    "q11": f'{CLASS_EXPR["C"]} {CLASS_EXPR["E"]}',
    "q12": f'{CLASS_EXPR["A"]}+ {CLASS_EXPR["I"]}+',
}

# Paper Table 2 ground truth (multi-source solution pairs, valid starts) —
# used by benchmarks to report side-by-side comparisons.
TABLE2_PAPER = {
    "q1": (1710, 477), "q2": (20, 477), "q3": (0, 477), "q4": (0, 477),
    "q5": (0, 477), "q6": (8, 2), "q7": (0, 731), "q8": (0, 366),
    "q9": (80905, 711), "q10": (2118, 354), "q11": (249, 364), "q12": (49638, 711),
}


def _zipf_sizes(total: int, n: int, alpha: float, rng: np.random.Generator) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1) ** alpha
    w /= w.sum()
    sizes = rng.multinomial(total, w)
    return sizes


def alibaba_like(
    n_nodes: int = 50_000,
    n_edges: int = 340_000,
    n_cooc_labels: int = 180,
    seed: int = 0,
) -> Graph:
    """Build the Alibaba statistical twin.  Deterministic for a given seed."""
    rng = np.random.default_rng(seed)

    # ---- node type layout (id ranges) ------------------------------------
    # proteins: dense C-interaction core; enzymes: acetylation targets with
    # A/I out-edges; compounds: A/I chain nodes; genes: E targets;
    # receptors/deadends: absorbing nodes; rest: co-occurrence background.
    n_protein = 600
    n_enzyme = 60
    n_compound = 1400
    n_gene = 500
    n_dead = 400
    proteins = np.arange(0, n_protein)
    enzymes = np.arange(n_protein, n_protein + n_enzyme)
    compounds = np.arange(n_protein + n_enzyme, n_protein + n_enzyme + n_compound)
    genes = np.arange(compounds[-1] + 1, compounds[-1] + 1 + n_gene)
    deadends = np.arange(genes[-1] + 1, genes[-1] + 1 + n_dead)
    background_lo = int(deadends[-1] + 1)

    labels = (
        C_LABELS + A_LABELS + I_LABELS
        + [l for l in E_LABELS if l not in A_LABELS]
        + P_LABELS + RARE_LABELS
        + [f"cooc_{i}" for i in range(n_cooc_labels)]
    )
    lmap = {name: i for i, name in enumerate(labels)}

    src_l: list[np.ndarray] = []
    lbl_l: list[np.ndarray] = []
    dst_l: list[np.ndarray] = []

    def add(s, label_names, d, rng=rng):
        s = np.asarray(s, np.int32)
        d = np.asarray(d, np.int32)
        names = rng.choice(label_names, size=len(s))
        src_l.append(s)
        lbl_l.append(np.array([lmap[n] for n in names], np.int32))
        dst_l.append(d)

    # ---- C-core: protein complexes (pockets of 6) -------------------------
    # C-interaction edges stay *within* a complex, so C+ closures are small
    # (~complex size), matching the paper's very selective C-prefix queries.
    # ~477 of the 600 proteins get out-C edges (valid starts for q1-q5).
    complex_of = proteins // 6
    cs_list, cd_list = [], []
    c_sources = rng.choice(proteins, size=477, replace=False)
    for p in c_sources:
        comp = complex_of[p]
        members = proteins[complex_of == comp]
        others = members[members != p]
        n_out = rng.integers(1, 4)
        cd_list.append(rng.choice(others, size=n_out))
        cs_list.append(np.full(n_out, p))
    add(np.concatenate(cs_list), C_LABELS, np.concatenate(cd_list))

    # ---- A-space: cascade blocks with a heavy tail -------------------------
    # Compounds are partitioned into contiguous blocks; A-edges form a
    # forward chain DAG *within* a block.  Two giant cascades (size 260)
    # give q9 its bulk (sum of suffix sizes ≈ 2·260²/2 ≈ 68k pairs); many
    # small blocks (≤6) keep q1/q6 selective.
    block_sizes = [260, 260]
    remaining = n_compound - sum(block_sizes)
    while remaining > 0:
        s = min(int(rng.integers(4, 7)), remaining)
        block_sizes.append(s)
        remaining -= s
    block_starts = np.cumsum([0] + block_sizes[:-1]) + compounds[0]
    block_of = np.zeros(n_compound, np.int64)
    for bi, (st, sz) in enumerate(zip(block_starts, block_sizes)):
        block_of[st - compounds[0] : st - compounds[0] + sz] = bi
    block_end = {bi: int(st + sz - 1) for bi, (st, sz) in enumerate(zip(block_starts, block_sizes))}

    # A-sources: every giant-block node + ~130 small-block nodes ≈ 711 with
    # the enzymes (paper: 711 valid starts for q9/q12).
    giant_nodes = np.concatenate(
        [np.arange(block_starts[0], block_end[0]), np.arange(block_starts[1], block_end[1])]
    )
    small_nodes = compounds[compounds > block_end[1]]
    all_small_heads = np.array(
        [int(block_starts[bi]) for bi, sz in enumerate(block_sizes) if sz <= 6], np.int64
    )
    # heads of 131 small blocks are sources => enzyme/fusion targets always
    # have an A-continuation (q1/q6 > 0 by construction)
    sourced_heads = rng.choice(all_small_heads, size=131, replace=False)
    a_sources = np.concatenate([giant_nodes, sourced_heads])
    a_s, a_d = [], []
    for v in a_sources:
        bi = block_of[v - compounds[0]]
        end = block_end[bi]
        if v >= end:
            continue
        a_s.append(v)  # chain edge keeps the cascade connected
        a_d.append(v + 1)
        # multi-scale skip edges: same suffix-reachability, log-ish diameter
        # (keeps the BFS level count — and real S2 round-trips — bounded)
        for step in (8, 64):
            if v + step <= end and rng.random() < 0.9:
                a_s.append(v)
                a_d.append(v + step)
    add(np.array(a_s), A_LABELS, np.array(a_d))

    # ---- enzymes: acetylation targets with *small-block* A-edges ----------
    enz_a_dst = rng.choice(sourced_heads, size=n_enzyme)
    add(enzymes, A_LABELS, enz_a_dst)

    # ---- acetylation: ~90 protein->enzyme edges from 30 complexes ---------
    acet_complexes = rng.choice(100, size=30, replace=False)
    acet_src = rng.choice(
        proteins[np.isin(complex_of, acet_complexes)], size=150
    )
    acet_dst = rng.choice(enzymes, size=150)
    add(acet_src, ["acetylation"], acet_dst)
    # q2 > 0 by construction: C-targeted proteins -> the I-capable enzymes
    q2_src = np.concatenate([cd_list[i][:1] for i in range(3)])
    add(q2_src, ["acetylation"], np.array([enzymes[0], enzymes[0], enzymes[1]]))

    # ---- methylation: protein -> deadend (0 continuations => q3/q4 = 0) ---
    add(rng.choice(proteins, size=40), ["methylation"], rng.choice(deadends, size=40))

    # ---- fusions: exactly 2 start nodes (paper: q6 has 2 valid starts) ----
    fus_src = np.array([proteins[0], proteins[1]], np.int32)
    add(fus_src, ["fusions"], sourced_heads[:2])
    # the two fusion-target blocks chain fully (q6 ≈ 8 by construction)
    fs, fd = [], []
    for head in sourced_heads[:2]:
        end = block_end[int(block_of[int(head) - compounds[0]])]
        for v in range(int(head) + 1, end):
            fs.append(v)
            fd.append(v + 1)
    add(np.array(fs), A_LABELS, np.array(fd))
    # fusions targets sit in small A-blocks and have no P edges => q5 = 0.

    # ---- I-chains: clustered runs inside the giant cascades ----------------
    # ~12 runs of 20 consecutive nodes carry I-edges (chains), plus ~114
    # isolated small-block sources => ~354 distinct I-starts, short I+
    # closures (q10 ≈ 2k), and A+∘I+ composition lands q12 in the tens of
    # thousands, mirroring Table 2's magnitudes.
    i_s, i_d = [], []
    run_heads = []
    for r in range(14):
        base = int(block_starts[r % 2]) + 2 + 36 * (r // 2)
        run_heads.append(base)
        for v in range(base, base + 19):
            i_s.append(v)
            i_d.append(v + 1)
    iso = rng.choice(small_nodes[:-1], size=114, replace=False)
    for v in iso:
        i_s.append(int(v))
        i_d.append(int(v) + 1)
    add(np.array(i_s), I_LABELS, np.array(i_d))
    # a couple of enzymes feed I near run tails (q2 small but non-zero)
    add(enzymes[:2], I_LABELS, np.array([run_heads[0] + 16, run_heads[1] + 16]))

    # ---- E edges: protein -> gene (q11 = C E, modest count) ---------------
    pure_e = [l for l in E_LABELS if l not in A_LABELS]
    e_src = rng.choice(proteins, size=190)
    e_dst = rng.choice(genes, size=190)
    add(e_src, pure_e, e_dst)

    # ---- receptor: A/I targets -> deadends (q7/q8 = 0: no P out-edges) ----
    rec_src = rng.choice(compounds, size=120)
    rec_dst = rng.choice(deadends, size=120)
    add(rec_src, ["receptor"], rec_dst)

    # ---- P edges: inside a disjoint pocket (so *receptor* P never fires) ---
    p_pocket = np.arange(background_lo, background_lo + 300)
    p_src = rng.choice(p_pocket, size=600)
    p_dst = rng.choice(p_pocket, size=600)
    add(p_src, P_LABELS, p_dst)

    # ---- co-occurrence background: the bulk of the 340k edges -------------
    used = sum(len(a) for a in src_l)
    n_bg = n_edges - used
    bg_sizes = _zipf_sizes(n_bg, n_cooc_labels, alpha=1.1, rng=rng)
    # power-law-ish node popularity for background endpoints
    pop = rng.zipf(1.5, size=n_nodes * 2) % n_nodes
    bg_src_pool = pop[: n_bg * 2]
    for li, size in enumerate(bg_sizes):
        if size == 0:
            continue
        s = rng.choice(bg_src_pool, size=size).astype(np.int32)
        d = rng.integers(0, n_nodes, size=size).astype(np.int32)
        src_l.append(s)
        lbl_l.append(np.full(size, lmap[f"cooc_{li}"], np.int32))
        dst_l.append(d)

    g = Graph(
        n_nodes,
        np.concatenate(src_l),
        np.concatenate(lbl_l),
        np.concatenate(dst_l),
        labels,
    )
    return g.dedup()
