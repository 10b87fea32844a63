"""The kernels' work, counted by formula.

``repro`` reads a step's FLOPs and bytes from XLA's ``cost_analysis``,
which sees a Pallas call as one custom call.  The port counts a step's
work with ``launch/analysis.py``'s ``count_step``: PyTorch's own ops
through a dispatch mode, and each kernel through this module.  A kernel
wrapper (B6 ``embedding_bag_sorted``, B7 ``flash_decode_gqa``) runs its
body inside :func:`kernel`, on every device type: on a meta tensor (a
shape-only run), on a CPU tensor (the plain version) and on a CUDA
tensor (the launch).  While a counter is installed, :func:`kernel`
reports the kernel's work from its formula and marks the body hidden, so
that the counter does not also count the plain version's own ops.  With
no counter installed it costs one list test and computes nothing, so the
wrappers' launch paths are unchanged.

A counter is any object with ``add_kernel(name, flops, nbytes, n,
tensor_core)``; it reads :func:`hidden` to skip a body's ops.
"""

from __future__ import annotations

import contextlib
from typing import Callable

_COUNTERS: list = []
_HIDDEN = 0  # depth of kernel bodies being run; a global, as autograd's device threads run backwards


@contextlib.contextmanager
def counting(counter):
    """Install ``counter`` for the body: every kernel call reports to it."""
    _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _COUNTERS.remove(counter)


def hidden() -> bool:
    """True inside a kernel body while a counter is installed: its ops are
    the kernel's, already counted by formula."""
    return _HIDDEN > 0


@contextlib.contextmanager
def kernel(name: str, work: Callable[[], tuple[float, float, int, bool]]):
    """Run the body as one call of kernel ``name``.  With a counter
    installed, ``work()`` gives (flops, bytes, n, tensor_core) by the
    kernel's formula (``n``: the count the formula scales with, lookups or
    key positions; ``tensor_core``: whether the FLOPs run on the tensor
    cores), which is reported once, and the body's own ops are hidden
    from the counter."""
    global _HIDDEN
    if not _COUNTERS:
        yield
        return
    flops, nbytes, n, tensor_core = work()
    for c in _COUNTERS:
        c.add_kernel(name, flops, nbytes, n, tensor_core)
    _HIDDEN += 1
    try:
        yield
    finally:
        _HIDDEN -= 1
