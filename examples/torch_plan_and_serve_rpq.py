"""End-to-end driver on the PyTorch port (the paper's kind: distributed
query serving).  The port of ``examples/plan_and_serve_rpq.py``, step for
step, on ``repro_torch``:

1. build the Alibaba statistical twin and distribute it arbitrarily over
   sites with replication (the paper's non-localized setting),
2. probe the network (§5.2.1) and stand up a ``repro_torch.serve.QueryService``
   over the placement — plan caching, signature-batched execution, and
   cost-feedback recalibration included,
3. replay a Table-2 query mix through the service twice (cold, then with
   a warm plan cache) and verify every answer against the centralized
   PAA oracle, printing ``OK`` or ``MISMATCH`` for each start.

The service runs on one device with ``mesh=None``: its S2 executors stay
on that card (``ServeConfig``'s default backend, as ``repro``'s), where
``repro``'s script builds a ``(data, model)`` mesh over
``jax.device_count()`` devices.  The port's service over ranks is a
program of one process a rank (``repro_torch.launch.ranks``), not a
single script.

Run:  PYTHONPATH=src python examples/torch_plan_and_serve_rpq.py [--small] [--device cpu]

``--device`` defaults to ``cuda``; without a GPU the script raises unless
it is given ``--device cpu``.
"""

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import paa, planner
from repro_torch.graph import generators
from repro_torch.graph.partition import distribute, random_overlay
from repro_torch.graph.structure import to_device_graph
from repro_torch.serve import QueryService, ServeConfig


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true", help="40k-edge twin (fast)")
    ap.add_argument("--queries", default="q1,q2,q6,q11")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(None) if args.device == "cuda" else torch.device(args.device)

    if args.small:
        g = generators.alibaba_like(n_nodes=8000, n_edges=40000, seed=0)
    else:
        g = generators.alibaba_like()
    print(f"twin: {g.n_nodes} nodes {g.n_edges} edges")

    net = random_overlay(150, 3.0, seed=1)
    probe_placement = distribute(g, 150, replication_rate=0.2, seed=1)
    params = planner.probe_network(net, probe_placement)
    print(f"probed: N_p={params.n_peers} N_c={params.n_connections} k̂={params.replication_rate:.3f}")

    n_exec_sites = 4
    print(f"device: {device} (one device, no mesh)")
    exec_placement = distribute(g, n_exec_sites, replication_rate=0.3, seed=2)
    dg = to_device_graph(g, device)

    service = QueryService(
        exec_placement, params,
        config=ServeConfig(n_rollouts=600, seed=3),
        device=device,
    )

    names = args.queries.split(",")
    for replay in ("cold", "warm"):
        tickets = []
        for qname in names:
            query = generators.TABLE2_QUERIES[qname]
            ca = paa.compile_query(query, g)
            starts = paa.valid_start_nodes(ca, g)[:2]
            if len(starts) == 0:
                print(f"{qname}: no valid start nodes, skipped")
                continue
            tickets.append((qname, ca, service.enqueue(query, starts)))
        service.flush()  # one batching window: plans, batches, executes

        print(f"\n--- {replay} replay ---")
        for qname, ca, t in tickets:
            ans = t.result()
            plan = ans.plan
            print(
                f"{qname}: {ans.strategy} ({plan.choice.reason}) "
                f"discr={plan.choice.discr:.4f} k/d={plan.choice.k_over_d:.4f} "
                f"cap={plan.s2_cost_cap} cache_hit={ans.plan_cache_hit} "
                f"latency={ans.latency_s * 1e3:.1f}ms"
            )
            for i, s in enumerate(ans.starts):
                oracle = set(
                    np.nonzero(paa.answers_single_source(ca, dg, int(s)).cpu().numpy())[0].tolist()
                )
                status = "OK" if ans.answers[i] == oracle else "MISMATCH"
                print(f"  start {int(s)}: {len(ans.answers[i])} answers [{status}]")

    s = service.summary()
    print(
        f"\nservice: {s['n_queries']} queries, {s['queries_per_sec']:.2f} q/s, "
        f"p50={s['p50_latency_s'] * 1e3:.1f}ms p95={s['p95_latency_s'] * 1e3:.1f}ms, "
        f"plan-cache hit rate {s['plan_cache_hit_rate']:.2f}, "
        f"exec cache builds {s['exec_cache']['builds']}"
    )


if __name__ == "__main__":
    main()
