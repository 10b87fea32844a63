"""Host ms in the planner (``QueryService._plan``: the plan-cache
lookup, a miss's §5 rollouts and compile, the §6 decision) per request
resolved in the window."""

UNIT, LAYER, MOVES, SOURCE = "ms", "planner", "rpq_per_s", "host_clock"


def read(run):
    if run.spans is None or not run.resolved:
        return None
    return run.spans.ms["plan"] / run.resolved
