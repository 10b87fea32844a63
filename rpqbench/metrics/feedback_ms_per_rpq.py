"""Host ms in the calibrator's feedback (``Calibrator.observe``, called
once per start of an S2 request and once per S1 request) per request
resolved in the window."""

UNIT, LAYER, MOVES, SOURCE = "ms", "feedback", "rpq_per_s", "host_clock"


def read(run):
    if run.spans is None or not run.resolved:
        return None
    return run.spans.ms["observe"] / run.resolved
