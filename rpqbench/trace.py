"""What a ``torch.profiler`` trace of the measured window says: the
device's busy time, its work by kernel and by ``s2_execute`` call, and
its idle time by the host span that was open over each part of it.

The host spans are those that :mod:`rpqbench.spans` timed on the host's
clock; they are put on the profiler's clock by the one
``rpqbench.window`` annotation around the whole window, whose start the
harness also took on the host's clock.  The device's records are read
from the profiler's raw results (``kineto_results.events()``): building
the profiler's Python event tree would take seconds for the window's
launches."""

from __future__ import annotations

import bisect
import collections

PREFIX = "rpqbench."


def _innermost(spans: list[tuple[float, float, str]]) -> list[tuple[float, float, str]]:
    """Properly nested spans flattened into disjoint segments, each named
    by the innermost span over it."""
    segs: list[tuple[float, float, str]] = []
    stack: list[tuple[float, float, str]] = []
    t = float("-inf")
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s:
            top = stack.pop()
            if top[1] > t:
                segs.append((t, top[1], top[2]))
            t = max(t, top[1])
        if stack and s > t:
            segs.append((t, s, stack[-1][2]))
        t = max(t, s)
        stack.append((s, e, name))
    while stack:
        top = stack.pop()
        if top[1] > t:
            segs.append((t, top[1], top[2]))
        t = max(t, top[1])
    return segs


def _spread(segs, starts, lo: float, hi: float, outside: str, into: collections.Counter) -> None:
    """Add the interval [lo, hi) to ``into`` by the segment over each part
    of it (``outside`` where none is)."""
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    t = lo
    while t < hi and i < len(segs):
        s, e, name = segs[i]
        if e <= t:
            i += 1
            continue
        if s > t:
            into[outside] += min(s, hi) - t
            t = min(s, hi)
            continue
        into[name] += min(e, hi) - t
        t = min(e, hi)
        i += 1
    if t < hi:
        into[outside] += hi - t


def reduce(prof, spans: list[tuple[float, float, str]], t_window: float) -> dict:
    """The trace of one window, reduced (times in seconds).  ``spans``
    are the host's (start, end, layer) and ``t_window`` the window's
    start, on the host's clock."""
    import torch

    windows: list[tuple[float, float]] = []
    device: list[tuple[float, float, str]] = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        lo, hi = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if name.startswith(PREFIX):
            if name == PREFIX + "window" and e.device_type() == torch.autograd.DeviceType.CPU:
                windows.append((lo, hi))
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((lo, hi, name))
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans, not one")
    w0, w1 = windows[0]
    shift = w0 - t_window
    host = [(s + shift, e + shift, n) for s, e, n in spans] + [(w0, w1, "window")]
    device = [d for d in device if w0 <= d[0] < w1]
    segs = _innermost(host)
    seg_starts = [s[0] for s in segs]
    calls = sorted((s, e) for s, e, n in host if n == "s2_execute")
    call_starts = [s for s, _ in calls]
    by_kernel: collections.Counter = collections.Counter()
    per_call = [0.0] * len(calls)
    busy, end = 0.0, w0
    idle: collections.Counter = collections.Counter()
    for lo, hi, name in sorted(device):
        by_kernel[name] += hi - lo
        i = bisect.bisect_right(call_starts, lo) - 1
        if i >= 0 and lo < calls[i][1]:
            per_call[i] += hi - lo
        if lo > end:
            _spread(segs, seg_starts, end, lo, "window", idle)
        hi = min(hi, w1)
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    if w1 > end:
        _spread(segs, seg_starts, end, w1, "window", idle)
    return {
        "window_s": w1 - w0,
        "clock_shift_s": shift,
        "busy_s": busy,
        "kernel_s": dict(by_kernel),
        "idle_s_by_span": dict(idle),
        "s2_call_device_s": per_call,
    }


def breakdown(tr: dict, top: int = 10) -> dict:
    """The ``breakdown`` of a traced result line: the device operations
    that took most time, and the idle time by the host span that was open
    over it (``window``: between flushes, in the client loop)."""
    ops = sorted(tr["kernel_s"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(tr["idle_s_by_span"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}
