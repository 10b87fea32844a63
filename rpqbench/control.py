#!/usr/bin/env python3
"""The control of a cell's check: the reference, its meters summed in
bfloat16 (one precision below the program's float32), put in the
program's place on the requests a run serves, judged as a run is.  Its
``meters_gap`` is the upper reading that the limit must stay below; it
has to come out not correct on every seed.

    python3 rpqbench/control.py --workload <cell> --seeds 1,2,3 --requests <n>

``--requests`` is how many of the window's requests a run serves; every
one is compared, as in a run.  Benchmark runs do not run this; it
imports nothing of the port."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--requests", type=int, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from rpqbench import bench, check, traffic

    cell = bench.load_cell(ROOT, args.workload)
    inputs = bench.make_inputs(cell.config)
    for seed in (int(s) for s in args.seeds.split(",")):
        _, stream = traffic.requests(cell.mix, cell.source, inputs, seed)
        items = [next(stream) for _ in range(args.requests)]
        served = check.control(items, inputs.index)
        checks = check.judge(served, inputs.index, cell.config["limits"])
        print(json.dumps({"workload": cell.name, "seed": seed, "compared": len(served),
                          "correct": check.passed(checks), "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
