"""The dry run: every (architecture × input shape) cell on the production
layouts, evaluated on the meta device.

Port of ``repro/launch/dryrun.py``, flag for flag.  ``repro`` forces 512
host devices, compiles each cell on the (16, 16) and (2, 16, 16) meshes
and reads XLA's analyses.  The port builds each cell's plan
(``launch/cells.py``: the one-card program on the cell's global shapes,
its inputs as meta tensors, their placements on the layout), runs the
step once on the meta device under ``launch/analysis.py``'s counters and
reports per-device argument and output bytes, the program's peak, its
FLOPs and bytes, an H100 roofline and the model FLOPs.  It computes
nothing and allocates nothing, and touches no GPU, as ``repro``'s touches
no TPU.  The one-card program does not depend on the layout, so a sweep
counts each cell once and analyses it on each layout.  ``analysis.FIELDS``
says what each reported field counts; no collective is counted.

Usage:
  python -m repro_torch.launch.dryrun --mesh single              # all cells
  python -m repro_torch.launch.dryrun --mesh multi --arch qwen3-14b --shape train_4k
  python -m repro_torch.launch.dryrun --list
"""

from __future__ import annotations

import argparse
import json
import time
import traceback

from repro_torch.configs import registry
from repro_torch.launch import analysis
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import make_production_mesh


def run_cell(arch: str, shape_name: str, multi_pod: bool, counts: dict, verbose: bool = True) -> dict:
    """Build one cell on one production layout, count its step and
    analyse it.  ``counts`` keeps each cell's count and its seconds, so a
    sweep counts a cell once for both layouts."""
    layout = make_production_mesh(multi_pod=multi_pod)
    t0 = time.perf_counter()
    plan = build_cell(arch, shape_name, layout)
    t_build = time.perf_counter() - t0
    if (arch, shape_name) not in counts:
        t0 = time.perf_counter()
        count = analysis.count_step(plan.fn, plan.args)
        counts[(arch, shape_name)] = (count, time.perf_counter() - t0)
    count, t_count = counts[(arch, shape_name)]
    stats = analysis.analyze_cell(plan, layout, count)
    stats["times"] = {"build_s": t_build, "count_s": t_count}
    stats["meta"] = {
        "arch": arch, "shape": shape_name, "mesh": f"{'multi' if multi_pod else 'single'}{layout.sizes}",
        "n_devices": layout.size, "kind": plan.kind, "n_params": plan.n_params,
        "n_active": plan.n_active, "tokens": plan.tokens,
    }
    if verbose:
        m, r = stats["memory"], stats["roofline"]
        print(f"  memory: args={m['argument_bytes'] / 2**30:.2f}GiB/device "
              f"out={m['output_bytes'] / 2**30:.2f}GiB/device "
              f"program peak={m['program_peak_bytes'] / 2**30:.2f}GiB (one card, global shapes)")
        print(f"  cost: {stats['cost']['flops']:.3e} flops, {stats['cost']['bytes']:.3e} B "
              f"(one-card program; counted in {t_count:.1f} s)")
        print(f"  roofline (H100, even split): compute={r['compute_s'] * 1e3:.2f}ms "
              f"memory={r['memory_s'] * 1e3:.2f}ms -> {r['bottleneck']}-bound")
    return stats


def all_cells() -> list[tuple[str, str]]:
    return [(arch, shape) for arch in registry.list_archs() for shape in registry.get_arch(arch).shapes]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="dryrun_results_torch.json")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    cells = all_cells()
    if args.list:
        for a, s in cells:
            print(f"{a} × {s}")
        return
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    try:
        with open(args.out) as f:
            results = json.load(f)
    except (OSError, json.JSONDecodeError):
        results = {}
    results["fields"] = analysis.FIELDS

    failures, counts = [], {}
    for multi in meshes:
        mesh_key = "multi" if multi else "single"
        for arch, shape in cells:
            key = f"{arch}|{shape}|{mesh_key}"
            if args.skip_existing and key in results and results[key].get("ok"):
                continue
            print(f"[{mesh_key}] {arch} × {shape} ...", flush=True)
            try:
                results[key] = {"ok": True, **run_cell(arch, shape, multi, counts)}
            except Exception as e:  # noqa: BLE001 — report, keep sweeping
                traceback.print_exc()
                results[key] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                failures.append(key)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    n_ok = sum(1 for k, r in results.items() if k != "fields" and r.get("ok"))
    print(f"\n{n_ok} ok, {len(failures)} failed")
    for k in failures:
        print("  FAILED:", k)


if __name__ == "__main__":
    main()
