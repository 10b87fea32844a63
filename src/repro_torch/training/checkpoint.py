"""Step-atomic checkpoints with elastic restore.

Port of ``repro/training/checkpoint.py``, in its layout exactly:

    <dir>/step_<n:08d>/
        manifest.json        # each leaf's path, shape and dtype; the step
        shard_<i>.npz        # the leaves as arrays a<k>, 64 to a shard
        COMMIT               # written last: a checkpoint without it is
                             # torn, and latest_step ignores it

written into ``step_<n>.tmp`` and renamed.  Leaf paths are ``repro``'s
key strings (``tree.leaves_with_paths``), so a checkpoint written by
either package restores in the other.  A bf16 leaf is written as
``repro`` writes one, its raw 2 bytes an element (npz has no bfloat16;
the arrays load as ``|V2``), with the manifest's dtype ``"bfloat16"``,
and :func:`restore` rebuilds every leaf by the manifest's dtype.
``repro``'s restore calls ``jnp.asarray`` on the raw array and raises on
a bf16 leaf (ROADMAP §C).

Restore is elastic: leaves are saved whole with their logical shapes
and placed on the devices of the tree they are restored into.  Over
ranks (an installed ``DeviceMesh``, one process a rank) ``save`` takes
the placement each rank holds its leaves under (``shardings``): the
leaves are gathered whole (``collectives.assemble_leaf``), rank 0 writes
them, and ``COMMIT`` is written only once every rank has agreed
(``collectives.agree``), so a checkpoint written over ranks is
``repro``'s layout, whole leaves, and restores on one card.
``restore(shardings=...)`` is ``repro``'s ``device_put`` onto the
current mesh: each rank reads the whole leaf and keeps its block
(``collectives.leaf_block``), so a checkpoint saved on one layout
restores on another.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.training.tree import leaves_with_paths, unflatten

_COMMIT = "COMMIT"
_CHUNK = 64  # leaves per npz shard

# manifest dtype -> (torch dtype, numpy dtype of the saved array)
_DTYPES = {
    "float32": (torch.float32, np.float32),
    "float64": (torch.float64, np.float64),
    "float16": (torch.float16, np.float16),
    "bfloat16": (torch.bfloat16, np.int16),  # raw 16 bits, saved as |V2
    "int32": (torch.int32, np.int32),
    "int64": (torch.int64, np.int64),
    "int8": (torch.int8, np.int8),
    "uint8": (torch.uint8, np.uint8),
    "bool": (torch.bool, np.bool_),
}
_NAMES = {t: name for name, (t, _) in _DTYPES.items()}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    torch_dtype, np_dtype = _DTYPES[dtype]
    t = torch.from_numpy(np.array(a).view(np_dtype))
    return (t.view(torch.bfloat16) if torch_dtype == torch.bfloat16 else t).to(device)


def save(ckpt_dir: str, step: int, tree, shardings=None) -> str:
    """Write a step-atomic checkpoint of a tree of tensors; returns the
    step directory.  On an installed mesh, ``shardings`` (a tree of
    ``tree``'s structure, or a list in leaf order, of the placements this
    rank holds each leaf under; ``None``: every leaf whole) gathers each
    leaf whole, rank 0 writes, and ``COMMIT`` follows every rank's
    agreement; every rank calls it."""
    mesh = shd.get_mesh()
    flat = leaves_with_paths(tree)
    places = _placements(shardings, len(flat))
    writer = mesh is None or collectives.mesh_rank(mesh) == 0
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"
    err = None
    try:
        if writer:
            if os.path.exists(tmp_dir):
                shutil.rmtree(tmp_dir)
            os.makedirs(tmp_dir, exist_ok=True)
        manifest = {"step": step, "leaves": [], "n_shards": -(-len(flat) // _CHUNK)}
        for si in range(manifest["n_shards"]):
            chunk = [(p, _whole(leaf, place, mesh))
                     for (p, leaf), place in zip(flat[si * _CHUNK : (si + 1) * _CHUNK],
                                                 places[si * _CHUNK : (si + 1) * _CHUNK])]
            manifest["leaves"] += [{"path": p, "shape": list(leaf.shape), "dtype": _NAMES[leaf.dtype]}
                                   for p, leaf in chunk]
            if writer:
                np.savez(
                    os.path.join(tmp_dir, f"shard_{si}.npz"),
                    **{f"a{si * _CHUNK + j}": _to_numpy(leaf) for j, (_, leaf) in enumerate(chunk)},
                )
        if writer:
            with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
                json.dump(manifest, f)
    except Exception as exc:  # every rank must reach the agreement
        if mesh is None:
            raise
        err = exc
    if mesh is not None and collectives.agree([err is not None], mesh)[0]:
        raise RuntimeError(f"a rank failed to save step {step}: no COMMIT written") from err
    if writer:
        with open(os.path.join(tmp_dir, _COMMIT), "w") as f:
            f.write("ok")
        if os.path.exists(step_dir):
            shutil.rmtree(step_dir)
        os.rename(tmp_dir, step_dir)
    if mesh is not None:
        collectives.agree([False], mesh)  # every rank sees the committed step
    return step_dir


def _placements(shardings, n: int) -> list:
    """``shardings`` as one placement a leaf, in leaf order (``None``:
    every leaf whole)."""
    if shardings is None:
        return [None] * n
    out = shd.placement_leaves(shardings)
    if len(out) != n:
        raise ValueError(f"{len(out)} placements for {n} leaves")
    return out


def _whole(leaf: torch.Tensor, place, mesh) -> torch.Tensor:
    """The whole leaf of this rank's block ``leaf`` under ``place``."""
    if mesh is None or not place:
        return leaf
    return collectives.assemble_leaf(leaf, place, mesh)


def latest_step(ckpt_dir: str) -> int | None:
    """The most recent *committed* step, ignoring torn checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, _COMMIT)):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like_tree, shardings=None, device=None):
    """Restore into the structure of ``like_tree``, a tree of tensors or
    meta tensors (the port's stand-in for ``jax.eval_shape``).  Each leaf
    is found by its path, rebuilt by the manifest's dtype and shape and
    put on its ``like_tree`` leaf's device; a meta leaf goes to
    ``device`` (None: the GPU).  ``shardings`` (a tree of ``like_tree``'s
    structure, or a list in leaf order, of placements; ``None`` entries
    whole) keeps this rank's block of each whole leaf on the installed
    mesh (``collectives.leaf_block``), ``repro``'s ``device_put`` onto
    the current mesh."""
    mesh = shd.get_mesh()
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)

    flat_arrays: list = [None] * len(manifest["leaves"])
    for si in range(manifest["n_shards"]):
        with np.load(os.path.join(step_dir, f"shard_{si}.npz")) as z:
            for name in z.files:
                flat_arrays[int(name[1:])] = z[name]

    saved_by_path = {m["path"]: i for i, m in enumerate(manifest["leaves"])}
    like = leaves_with_paths(like_tree)
    places = _placements(shardings, len(like))
    out = []
    for (p, leaf), place in zip(like, places):
        i = saved_by_path[p]
        meta = manifest["leaves"][i]
        dev = leaf.device if leaf.device.type != "meta" else resolve_device(device)
        t = _from_numpy(flat_arrays[i], meta["dtype"], "cpu").reshape(meta["shape"])
        if place and mesh is not None:
            t = collectives.leaf_block(t, place, mesh).contiguous()
        out.append(t.to(dev))
    return unflatten(like_tree, out)


def prune(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(n.split("_")[1])
        for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and not n.endswith(".tmp")
    )
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
