"""Process start for the mesh programs: one process per rank.

``repro`` runs a mesh program as one ``shard_map`` over the devices of
one process.  The port runs one process per rank (``torch.distributed``),
each rank the program's body on its local shard
(:mod:`repro_torch.dist.collectives`).  A rank calls :func:`init_rank`,
which joins the process group, then builds its ``DeviceMesh``
(``launch.mesh.make_test_mesh``).  :func:`run_ranks` spawns the ranks
of one host and waits for them.

A rank's device is ``cuda:{rank % device_count}``; the CPU only when the
caller asks for it (``device="cpu"``, as the tests do), never because no
GPU is found.  The kernels are built before the ranks start
(:func:`run_ranks` on a CUDA device calls ``_build.build_all``), so
ranks only load them: the loader locks per thread, not per process.
"""

from __future__ import annotations

import datetime
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import resolve_device


def rank_device(rank: int, device: str | torch.device | None = None) -> torch.device:
    """The device of rank ``rank`` on its host: ``device`` when it names
    one, else (``None`` or ``"cuda"``) ``cuda:{rank % device_count}``
    (raises without a GPU)."""
    dev = resolve_device(device)  # raises without a GPU when None
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def init_rank(
    rank: int,
    world_size: int,
    store_path: str,
    backend: str | None = None,
    device: str | torch.device | None = None,
    timeout_s: float = 600.0,
) -> torch.device:
    """Join the process group of ``world_size`` ranks as ``rank``,
    rendezvousing on a ``FileStore`` at ``store_path`` (a path no earlier
    group used); set and return the rank's device.  ``backend``: NCCL on
    a CUDA device, ``gloo`` on the CPU, unless named (``gloo`` ranks may
    share a card, which NCCL refuses).  Collectives that wait longer than
    ``timeout_s`` raise."""
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world_size), rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return dev


def run_ranks(fn, world_size: int, args: tuple = (), timeout_s: float = 600.0,
              device: str | torch.device | None = None) -> None:
    """Spawn ``world_size`` processes running ``fn(rank, *args)`` and wait
    for them all.  ``fn`` must be importable by name (a module-level
    function).  On a CUDA ``device`` (``None``: the GPU) the kernels are
    built first.  Raises the first rank's exception, or ``TimeoutError``
    after ``timeout_s``, when every rank left is stopped."""
    if resolve_device(device).type == "cuda":
        from repro_torch.kernels import _build

        _build.build_all()
    ctx = mp.start_processes(fn, args=args, nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.0, min(1.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world_size} ranks still running after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(timeout=10)


__all__ = ["init_rank", "rank_device", "run_ranks"]
