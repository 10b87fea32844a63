"""Host ms in the S2 executor (``strategies.s2_execute``, which ends in
the answers' and meters' copy to the host) per request resolved in the
window."""

UNIT, LAYER, MOVES, SOURCE = "ms", "S2 executor", "rpq_per_s", "host_clock"


def read(run):
    if run.spans is None or not run.resolved:
        return None
    return run.spans.ms["s2_execute"] / run.resolved
