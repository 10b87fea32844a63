"""The share of the traced window in which no operation ran on the card:
1 - device busy / window, from ``torch.profiler``."""

UNIT, LAYER, MOVES, SOURCE = "%", "device", "rpq_per_s", "device_trace"


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
