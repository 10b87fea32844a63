#!/usr/bin/env python3
"""The one-card S2 fixpoints at several ``ops.LEVELS_PER_CHECK`` on one
NVIDIA GPU, beside the eager one-level loop, in one process:

    python3 tools/torch_fixpoint_k_sweep.py [--rounds 2] [--ks 8,4,2]

On ``chip_smoke.py``'s setup (the 50,000-node Alibaba twin on 256 sites,
both Stage-A stores on the card) each round runs, for each k and then the
eager loop (``ops.EAGER``, k = 1: the per-level loop's work with one host
read a level), the serve phase's run (a) (the 144-request stream on
``frontier_kernel_packed`` over the bit-plane store, a fresh
``QueryService``: cold, then twice warm) and a warm run (the second of
two on one executor) of q1, q9 and q12 on each of the four paths.  Rounds
alternate the order of the settings.  It prints the card's name and
power limit, then one JSON line per (round, setting): wall ms and the
``s2_execute`` host ms of each serve run with its bodies and BFS levels,
and each path query's warm ms.  It checks no answer (``chip_smoke.py``
does) and exits non-zero without a GPU.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import strategies  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.frontier import ops as fops  # noqa: E402
from repro_torch.serve import QueryService  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--ks", default="8,4,2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fixpoint_k_sweep: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    _build.build_all()
    g = cs.alibaba_like(seed=cs.SEED)
    pl = cs.distribute(g, n_sites=cs.RPQ.n_sites, replication_rate=cs.RPQ.replication_rate, seed=cs.SEED)
    net, stream = cs.serve_net(pl), cs.serve_stream(g)
    stores = {td: fops.stage_graph(g, 128, tile_dtype=td, device=dev) for td in ("f32", "uint32")}
    cas = {q: cs.paa.compile_query(cs.TABLE2_QUERIES[q], g) for q in cs.QUERIES}
    starts = {q: cs.paa.valid_start_nodes(cas[q], g) for q in cs.QUERIES}
    settings = [(int(k), False) for k in args.ks.split(",")] + [(1, True)]
    k0 = fops.LEVELS_PER_CHECK
    for rnd in range(args.rounds):
        for k, eager in settings if rnd % 2 == 0 else settings[::-1]:
            fops.LEVELS_PER_CHECK, fops.EAGER = k, eager
            try:
                row = {"round": rnd, "k": k, "eager": eager}
                svc = QueryService(pl, net, config=cs.serve_config(s2_backend="frontier_kernel_packed",
                                                                   s2_tile_dtype="uint32"), device=dev)
                for run in ("cold", "warm1", "warm2"):
                    _, r = cs.serve_sync(svc, stream)
                    row[f"serve_{run}"] = {"wall_ms": r["wall_s"] * 1e3, "s2_execute_ms": r["layers_ms"]["s2_execute"],
                                           "bodies": fops.FIXPOINT_COUNTERS["bodies"],
                                           "levels": fops.FIXPOINT_COUNTERS["levels"]}
                del svc
                for name, kk in cs.KERNELS.items():
                    td = kk["tile_dtype"]
                    for q in cs.QUERIES:
                        step = strategies.make_s2_step_fn(
                            cas[q], g.n_nodes, backend=kk["backend"], graph=g,
                            replication_factor=pl.replication_factor, tile_dtype=td, staged=stores[td], device=dev)
                        for _ in range(2):
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                            strategies.s2_execute(pl, cas[q], starts[q], step_fn=step)
                            torch.cuda.synchronize()
                        row[f"{name}/{q}_warm_ms"] = (time.perf_counter() - t0) * 1e3
                        step.release()
            finally:
                fops.LEVELS_PER_CHECK, fops.EAGER = k0, False
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
