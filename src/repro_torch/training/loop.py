"""Fault-tolerant training loop.

Port of ``repro/training/loop.py``.  Checkpoint/restart semantics: the
loop always begins from ``checkpoint.latest_step`` (None: a fresh init),
saves every ``ckpt_every`` steps atomically, and is idempotent — killing
the process at any point and running it again converges to the same
trajectory, because the batches are deterministic in (seed, step) and
the checkpoint is step-atomic.  Steps run eagerly (``repro`` jits
them); ``tests/test_torch_training.py`` crashes the loop mid-run and
asserts a bit-identical resume against an uninterrupted run.

On resume ``repro`` restores into ``jax.eval_shape(init_fn)``.  The
port's initialisers draw from a generator on their device, which has no
shape-only evaluation, so the loop restores into ``init_fn()``'s own
tree: its structure and each leaf's device (``checkpoint.restore`` also
takes a meta tree).

Over ranks (an installed ``DeviceMesh``, every rank calling ``run``):
rank 0 picks ``latest_step`` and broadcasts it, each rank restores its
block of each whole leaf (``shardings``: the placements it holds
``(params, opt_state)`` under), and a save gathers the leaves whole,
rank 0 writes them and prunes, and ``COMMIT`` follows every rank's
agreement (``checkpoint.save``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.training import checkpoint


@dataclasses.dataclass
class TrainLoopResult:
    params: Any
    opt_state: Any
    losses: list[float]
    start_step: int
    end_step: int


def run(
    *,
    init_fn: Callable[[], tuple[Any, Any]],
    train_step: Callable,
    batch_fn: Callable[[int], Any],
    n_steps: int,
    ckpt_dir: str | None = None,
    ckpt_every: int = 10,
    keep: int = 3,
    crash_at_step: int | None = None,
    log_every: int = 0,
    shardings=None,
) -> TrainLoopResult:
    """Run (or resume) training.  ``crash_at_step`` simulates a node
    failure (raises) for the fault-tolerance tests.  ``shardings``: on a
    mesh, the placements of this rank's ``(params, opt_state)`` leaves
    (``None``: whole)."""
    mesh = shd.get_mesh()
    start = 0
    params = opt_state = None
    if ckpt_dir is not None:
        latest = _latest(ckpt_dir, mesh)
        if latest is not None:
            params, opt_state = checkpoint.restore(ckpt_dir, latest, init_fn(), shardings=shardings)
            start = latest
    if params is None:
        params, opt_state = init_fn()

    losses: list[float] = []
    for step in range(start, n_steps):
        if crash_at_step is not None and step == crash_at_step:
            raise RuntimeError(f"simulated node failure at step {step}")
        batch = batch_fn(step)
        params, opt_state, loss = train_step(params, opt_state, batch)
        losses.append(float(loss))
        if log_every and step % log_every == 0:
            print(f"step {step}: loss {float(loss):.4f}", flush=True)
        if ckpt_dir is not None and (step + 1) % ckpt_every == 0:
            _save(ckpt_dir, step + 1, (params, opt_state), shardings, keep, mesh)
    if ckpt_dir is not None:
        _save(ckpt_dir, n_steps, (params, opt_state), shardings, keep, mesh)
    return TrainLoopResult(params, opt_state, losses, start, n_steps)


def _latest(ckpt_dir: str, mesh) -> int | None:
    """``checkpoint.latest_step``, read by rank 0 and broadcast on a mesh."""
    if mesh is None:
        return checkpoint.latest_step(ckpt_dir)
    mine = collectives.mesh_rank(mesh) == 0
    step = checkpoint.latest_step(ckpt_dir) if mine else None
    got = collectives.broadcast_bytes(str(-1 if step is None else step).encode() if mine else None, mesh)
    return None if int(got) < 0 else int(got)


def _save(ckpt_dir: str, step: int, tree, shardings, keep: int, mesh) -> None:
    checkpoint.save(ckpt_dir, step, tree, shardings=shardings if mesh is not None else None)
    if mesh is None or collectives.mesh_rank(mesh) == 0:
        checkpoint.prune(ckpt_dir, keep=keep)
