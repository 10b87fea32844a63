"""The S2 calls' share of their roofline: the least time the card could
take for the calls' work (:mod:`rpqbench.roofline`: each adjacency tile
that a start's BFS leaves from read once, starts read and answer rows
written once, at the card's memory bandwidth), over the device time of
every operation launched inside ``s2_execute``, over every call of the
window."""

from rpqbench import roofline
from rpqbench.reference import bfs

UNIT, LAYER, MOVES, SOURCE = "%", "level kernels", "rpq_per_s", "device_trace"


def read(run):
    if run.trace is None or run.spans is None or not run.spans.s2_calls:
        return None
    calls, device_s = run.spans.s2_calls, run.trace["s2_call_device_s"]
    if len(calls) != len(device_s):
        raise RuntimeError(f"{len(calls)} s2_execute calls but {len(device_s)} traced spans")
    block = run.config["serve"].get("s2_block_size", 128)
    memo, least, spent = {}, 0, 0.0
    for (query, starts, _, _), spent_i in zip(calls, device_s):
        key = (query, starts.tobytes())
        if key not in memo:
            memo[key] = roofline.least_bytes(bfs.compile_query(query, run.index), run.index, starts, block)
        least += memo[key]
        spent += spent_i
    if spent <= 0:
        return None
    return 100.0 * least / roofline.peak(run.device_kind, "hbm_bytes_per_s") / spent
