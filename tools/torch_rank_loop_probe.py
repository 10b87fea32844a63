#!/usr/bin/env python3
"""The per-rank S2 fixpoints and S1's BFS on one NVIDIA GPU, timed on
the tree given, so that two trees compare in one call:

    python3 tools/torch_rank_loop_probe.py [--tree DIR] [--tag NAME] [--reps 5]

It imports ``repro_torch`` and ``chip_smoke.py`` from ``--tree`` (default:
this checkout; a parent commit unpacked with ``git archive`` runs as it
was), on ``chip_smoke.py``'s setup (the 50,000-node Alibaba twin, its
256-site placement and the 16-site one), and times, on one NCCL rank of
a (1, 1) mesh in this process:

* the mesh phase's (a): the sharded backend on the 16 sites over the
  bit-plane store (B3) and the reference backend on the 256 sites, pairs
  and witness, on the first 64 valid starts of q1, q9 and q12: one
  executor a case, a first call (on a card it captures the rank's loop),
  then ``--reps`` warm calls, each with its levels, host syncs, bodies and
  ``all_reduce`` calls;
* the mesh_serve phase's one-rank service: serve run (h)'s first 48
  requests on the sharded backend (bit-plane tiles, 16 sites), cold and
  warm;
* the plan phase's S1 BFS: for each Table-2 query, 8 sampled valid starts
  on the deduplicated subgraph S1 gathers, ``paa.answers_single_source``
  on its device form, with the BFS's levels and host syncs.

It prints the card's name and power limit, then one JSON line.  It checks
no answer (``chip_smoke.py`` does) and exits non-zero without a GPU.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT), help="the checkout whose repro_torch and chip_smoke.py run")
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]

    import numpy as np
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("torch_rank_loop_probe: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import paa, strategies
    from repro_torch.dist import collectives
    from repro_torch.kernels import _build
    from repro_torch.kernels.frontier import ops as fops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import ranks
    from repro_torch.serve import QueryService

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    g = cs.alibaba_like(seed=cs.SEED)
    placement = cs.distribute(g, n_sites=cs.RPQ.n_sites, replication_rate=cs.RPQ.replication_rate, seed=cs.SEED)
    pl16 = cs.distribute(g, n_sites=cs.SHARD_SITES, replication_rate=cs.RPQ.replication_rate, seed=cs.SEED)
    cas = {q: paa.compile_query(cs.TABLE2_QUERIES[q], g) for q in cs.QUERIES}
    starts = {q: paa.valid_start_nodes(cas[q], g)[:64] for q in cs.QUERIES}
    row = {"tag": args.tag, "tree": str(tree), "torch": torch.__version__}

    def counts() -> dict:
        c = fops.FIXPOINT_COUNTERS
        return {"levels": c["levels"], "host_syncs": c["host_syncs"], "bodies": c["bodies"],
                "captures": c["captures"], "all_reduces": collectives.WIRE_COUNTERS["all_reduces"],
                "wire_bytes": collectives.WIRE_COUNTERS["bytes"]}

    def timed(fn) -> tuple[float, dict]:
        fops.FIXPOINT_COUNTERS.clear()
        collectives.WIRE_COUNTERS.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, counts()

    tmp = tempfile.mkdtemp(prefix="rank-loop-probe-")
    ranks.init_rank(0, 1, os.path.join(tmp, "store"), device=dev, timeout_s=600)
    try:
        mesh = mesh_lib.make_test_mesh(1, 1)
        store = cs.plans.GraphPlanStore(device=dev)
        arrays = strategies.stage_site_arrays(placement, dev, mesh)
        cases = [("sharded_i", pl16, "frontier_kernel_sharded", "uint32", "pairs")]
        cases += [(f"reference_{sem}", placement, "reference", "f32", sem) for sem in ("pairs", "witness")]
        for name, pl, backend, td, sem in cases:
            for q in cs.QUERIES:
                step = strategies.make_s2_step_fn(cas[q], g.n_nodes, backend=backend, graph=g, tile_dtype=td,
                                                  semantics=sem, device=dev, plan_store=store, placement=pl,
                                                  mesh=mesh)
                kw = {"device_arrays": arrays} if backend == "reference" else {}

                def run():
                    strategies.s2_execute(pl, cas[q], starts[q], step_fn=step, semantics=sem, **kw)

                first_ms, first = timed(run)
                warm = [timed(run) for _ in range(args.reps)]
                step.release()
                row[f"a/{name}/{q}"] = {"first_ms": first_ms, "first": first,
                                        "warm_ms": [ms for ms, _ in warm], "warm_median_ms": float(
                                            np.median([ms for ms, _ in warm])), "warm": warm[-1][1]}
                print(json.dumps({f"a/{name}/{q}": row[f"a/{name}/{q}"]}), flush=True)
        del arrays, store

        prefix = cs.serve_stream(g)[:cs.SERVE_PREFIX]
        svc = QueryService(pl16, cs.serve_net(pl16), config=cs.serve_config(
            s2_backend="frontier_kernel_sharded", s2_tile_dtype="uint32"), device=dev, mesh=mesh)
        for run_name in ("cold", "warm1", "warm2"):
            ms, c = timed(lambda: cs.serve_windows(svc, prefix))
            row[f"serve_h/{run_name}"] = {"wall_ms": ms, **c}
        print(json.dumps({k: v for k, v in row.items() if k.startswith("serve_h")}), flush=True)
        del svc
    finally:
        dist.destroy_process_group()

    # the plan phase's S1 BFS, on one card
    arrays = strategies.stage_site_arrays(placement, dev)
    rng = np.random.default_rng(cs.SEED)
    s1 = {}
    for q, expr in cs.TABLE2_QUERIES.items():
        ca = paa.compile_query(expr, g)
        valid = paa.valid_start_nodes(ca, g)
        if len(valid) == 0:
            continue
        sample = np.sort(rng.choice(valid, size=min(8, len(valid)), replace=False))
        lmask = strategies.query_label_mask(cs.rx.parse(expr), g)
        src, lbl, dst, valid_m, _ = strategies.s1_gather(arrays, lmask, arrays["src"].shape[1])
        sub = strategies.gathered_subgraph(g, src, lbl, dst, valid_m)
        bfs_ms = []
        paa.BFS_COUNTERS.clear()
        for s in sample.tolist():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            paa.answers_single_source(ca, paa.device_form(sub, dev), s).cpu().numpy()
            bfs_ms.append((time.perf_counter() - t0) * 1e3)
        s1[q] = {"starts": len(sample), "bfs_ms": bfs_ms, "bfs_median_ms": float(np.median(bfs_ms)),
                 "levels": paa.BFS_COUNTERS["levels"], "host_syncs": paa.BFS_COUNTERS["host_syncs"]}
    row["s1_bfs"] = s1
    row["s1_bfs_total_ms"] = sum(sum(v["bfs_ms"]) for v in s1.values())
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
