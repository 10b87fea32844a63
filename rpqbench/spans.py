"""Host spans around the calls into the service's layers, from outside
the program: the wrappers of ``chip_smoke.py``'s ``ServeTimers``, copied,
each also opening a ``torch.profiler.record_function`` named
``rpqbench.<layer>`` so that a trace can put the device's work and its
idle gaps under the layer the host was in.

Layers: ``flush`` (``QueryService.flush``), ``plan`` (``_plan``),
``s2_group`` (``batcher.run_s2_group``), ``s2_execute``
(``strategies.s2_execute``, which ends in the answers' copy to the
host) and ``observe`` (``Calibrator.observe``)."""

from __future__ import annotations

import collections
import time

import numpy as np
import torch


class Spans:
    """Installs the wrappers on ``svc`` and the modules it calls;
    :meth:`stop` takes them off.  ``ms[layer]`` sums the host ms in each
    layer; ``intervals`` lists every call as (host start, host end,
    layer) and ``s2_calls`` each ``s2_execute`` call as (query of its
    signature group, its distinct starts, host start, host end), in
    ``time.perf_counter`` seconds."""

    def __init__(self, svc, strategies, batcher):
        self.ms: collections.Counter = collections.Counter()
        self.s2_calls: list[tuple[str, np.ndarray, float, float]] = []
        self.intervals: list[tuple[float, float, str]] = []
        self._group_query: str | None = None
        self._undo: list = []
        self._wrap(svc, "flush", "flush")
        self._wrap(svc, "_plan", "plan")
        self._wrap(svc.calibrator, "observe", "observe")
        self._wrap(batcher, "run_s2_group", "s2_group")
        self._wrap(strategies, "s2_execute", "s2_execute")

    def _wrap(self, obj, attr: str, layer: str) -> None:
        fn = getattr(obj, attr)
        tag = f"rpqbench.{layer}"

        def timed(*args, **kwargs):
            if layer == "s2_group":
                self._group_query = args[0][0].query
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(tag):
                    return fn(*args, **kwargs)
            finally:
                t1 = time.perf_counter()
                self.ms[layer] += (t1 - t0) * 1e3
                self.intervals.append((t0, t1, layer))
                if layer == "s2_execute":
                    self.s2_calls.append((self._group_query, np.unique(np.asarray(args[2])), t0, t1))

        self._undo.append((obj, attr, obj.__dict__.get(attr)))
        setattr(obj, attr, timed)

    def stop(self) -> None:
        for obj, attr, own in reversed(self._undo):
            if own is None:
                delattr(obj, attr)  # the instance's method again
            else:
                setattr(obj, attr, own)
        self._undo.clear()
