#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card of this machine.

    python3 rpqbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (JSON: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last: each
number compared with its limit); the last lines of standard error give
the same numbers.  It exits non-zero, with no result, where the machine
has no CUDA card or fewer than the cell asks for, where the port cannot
be imported, or where a module of JAX or of the JAX package ``repro`` is
loaded once the window has closed.  Builds and kernel caches stay inside
the checkout (``build/``); raw latencies go to ``$TMPDIR``.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from rpqbench import bench

    cell = bench.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"rpqbench: {args.workload} needs {cell.chips} CUDA card(s), this machine has {n}", file=sys.stderr)
        return 2
    result, checks = bench.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    loaded = bench.forbidden_modules()
    if loaded:
        print(f"rpqbench: modules of JAX or of repro are loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
