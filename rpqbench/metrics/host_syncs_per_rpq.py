"""The fixpoint loops' reads of their flag on the host
(``ops.FIXPOINT_COUNTERS["host_syncs"]``, one a body of
``LEVELS_PER_CHECK`` levels) over the window, per request resolved."""

UNIT, LAYER, MOVES, SOURCE = "syncs", "fixpoint loop", "rpq_per_s", "program_counter"


def read(run):
    if run.spans is None or not run.resolved:
        return None
    return run.host_syncs / run.resolved
