"""The dry run: every (architecture × input shape) cell on the production
layouts, evaluated on the meta device.

Port of ``repro/launch/dryrun.py``, flag for flag.  ``repro`` forces 512
host devices, compiles each cell on the (16, 16) and (2, 16, 16) meshes
and reads XLA's analyses per device.  The port builds, in this process, a
``fake`` process group of the layout's 256 or 512 ranks and its
``DeviceMesh`` (``launch/mesh.py``'s ``fake_mesh``, torn down between the
layouts), and each cell's plan (``launch/cells.py``): the program rank 0
runs at the layout on its own blocks, as meta tensors, and the one-card
program on the cell's global shapes.  It runs both once on the meta
device under ``launch/analysis.py``'s counters and reports per device:
``repro``'s argument bytes from its placements, the rank's argument,
output and peak bytes, its FLOPs and bytes, its collectives by kind
(logical bytes, as ``repro``'s ``collective_bytes`` reads them, beside the
port's wire bytes), a three-term H100 roofline, and the one-card
program's even split over the devices with the ratio of the rank's FLOPs
to it (above 1: work every rank repeats).  It computes nothing,
allocates nothing and touches no GPU, as ``repro``'s touches no TPU.
The rank's program depends on the layout, so a sweep counts it once a
(cell, layout), and the one-card program once a cell.
``analysis.FIELDS`` says what each reported field counts.

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
from repro_torch.launch.mesh import fake_mesh, make_production_mesh


def run_cell(arch: str, shape_name: str, multi_pod: bool, counts: dict, verbose: bool = True,
             mesh=None, even_split: bool = True) -> dict:
    """Build one cell on one production layout, count rank 0's program
    and (with ``even_split``) the one-card program, and analyse it.
    ``mesh`` is the layout's ``DeviceMesh`` over a fake group (``None``:
    one is built for this cell); ``counts`` keeps each cell's one-card
    count and its seconds, so a sweep counts it once for both layouts."""
    layout = make_production_mesh(multi_pod=multi_pod)
    if mesh is None:
        with fake_mesh(layout) as m:
            return run_cell(arch, shape_name, multi_pod, counts, verbose, m, even_split)
    t0 = time.perf_counter()
    plan = build_cell(arch, shape_name, layout, mesh)
    t_build = time.perf_counter() - t0
    one_card, t_one = None, None
    if even_split:
        if (arch, shape_name) not in counts:
            t0 = time.perf_counter()
            count = analysis.count_step(plan.fn, plan.args)
            counts[(arch, shape_name)] = (count, time.perf_counter() - t0)
        one_card, t_one = counts[(arch, shape_name)]
    t0 = time.perf_counter()
    rank = analysis.count_step(plan.rank.fn, plan.rank.args)
    t_rank = time.perf_counter() - t0
    stats = analysis.analyze_cell(plan, layout, rank, one_card)
    stats["times"] = {"build_s": t_build, "count_s": t_rank, "one_card_count_s": t_one}
    stats["meta"] = {
        "arch": arch, "shape": shape_name, "mesh": f"{'multi' if multi_pod else 'single'}{layout.sizes}",
        "n_devices": layout.size, "kind": plan.kind, "n_params": plan.n_params,
        "n_active": plan.n_active, "tokens": plan.tokens,
    }
    if verbose:
        m, c, r, coll = stats["memory"], stats["cost"], stats["roofline"], stats["collectives"]
        print(f"  memory: args={m['argument_bytes'] / 2**30:.2f}GiB/device (repro's placements), "
              f"rank holds {c['rank_argument_bytes'] / 2**30:.2f}GiB, out={m['output_bytes'] / 2**30:.2f}GiB, "
              f"rank peak={m['program_peak_bytes'] / 2**30:.2f}GiB")
        ratio = None if c["even_split"] is None else c["even_split"]["flops_ratio"]
        print(f"  cost: {c['flops']:.3e} flops, {c['bytes']:.3e} B on rank 0 (counted in {t_rank:.1f} s); "
              + ("no even split" if ratio is None else f"{ratio:.3f}x the one-card program's even split"))
        if coll is None:
            print("  collectives: none issued")
        else:
            kinds = ", ".join(f"{k} {coll[k]['calls']}x {coll[k]['bytes'] / 2**20:.2f}MiB"
                              for k in analysis.KINDS if coll[k]["calls"])
            print(f"  collectives: {kinds or 'none over more than one rank'}; "
                  f"{coll['wire_bytes'] / 2**20:.2f}MiB on the wire")
        coll_ms = "-" if r["collective_s"] is None else f"{r['collective_s'] * 1e3:.2f}ms"
        print(f"  roofline (H100, rank 0): compute={r['compute_s'] * 1e3:.2f}ms "
              f"memory={r['memory_s'] * 1e3:.2f}ms collective={coll_ms} -> {r['bottleneck']}-bound")
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
        with fake_mesh(make_production_mesh(multi_pod=multi)) as mesh:
            for arch, shape in cells:
                key = f"{arch}|{shape}|{mesh_key}"
                if args.skip_existing and key in results and results[key].get("ok"):
                    continue
                print(f"[{mesh_key}] {arch} × {shape} ...", flush=True)
                try:
                    results[key] = {"ok": True, **run_cell(arch, shape, multi, counts, mesh=mesh)}
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
