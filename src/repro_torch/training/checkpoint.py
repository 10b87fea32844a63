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
and placed on the devices of the tree they are restored into.  Placing
them on several cards (``repro``'s ``shardings``) waits for the
multi-GPU item.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch import resolve_device
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


def save(ckpt_dir: str, step: int, tree) -> str:
    """Write a step-atomic checkpoint of a tree of tensors; returns the
    step directory."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)

    flat = leaves_with_paths(tree)
    manifest = {
        "step": step,
        "leaves": [{"path": p, "shape": list(leaf.shape), "dtype": _NAMES[leaf.dtype]} for p, leaf in flat],
        "n_shards": -(-len(flat) // _CHUNK),
    }
    for si in range(manifest["n_shards"]):
        chunk = flat[si * _CHUNK : (si + 1) * _CHUNK]
        np.savez(
            os.path.join(tmp_dir, f"shard_{si}.npz"),
            **{f"a{si * _CHUNK + j}": _to_numpy(leaf) for j, (_, leaf) in enumerate(chunk)},
        )
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp_dir, _COMMIT), "w") as f:
        f.write("ok")
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)
    return step_dir


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
    ``device`` (None: the GPU).  ``shardings`` places leaves on several
    cards in ``repro``; here anything but None raises."""
    if shardings is not None:
        raise NotImplementedError(
            "restoring onto a mesh of several cards is ROADMAP's multi-GPU item: the port "
            "restores onto one device"
        )
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)

    flat_arrays: list = [None] * len(manifest["leaves"])
    for si in range(manifest["n_shards"]):
        with np.load(os.path.join(step_dir, f"shard_{si}.npz")) as z:
            for name in z.files:
                flat_arrays[int(name[1:])] = z[name]

    saved_by_path = {m["path"]: i for i, m in enumerate(manifest["leaves"])}
    out = []
    for p, leaf in leaves_with_paths(like_tree):
        i = saved_by_path[p]
        meta = manifest["leaves"][i]
        dev = leaf.device if leaf.device.type != "meta" else resolve_device(device)
        t = _from_numpy(flat_arrays[i], meta["dtype"], dev)
        out.append(t.reshape(meta["shape"]))
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
