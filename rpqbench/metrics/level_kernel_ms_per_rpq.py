"""Device ms of the configuration's level kernel (its symbol's pieces are
the configuration's ``level_kernel``: B1 ``f32_chunk_kernel<LevelSchedule,
AddF32>``, B4 ``bitplane_level_kernel<OrLanes>``) over the traced window,
per request resolved."""

UNIT, LAYER, MOVES, SOURCE = "ms", "level kernels", "rpq_per_s", "device_trace"


def read(run):
    if run.trace is None or not run.resolved:
        return None
    pieces = run.config["level_kernel"]
    s = sum(t for name, t in run.trace["kernel_s"].items() if all(p in name for p in pieces))
    return 1e3 * s / run.resolved if s else None
