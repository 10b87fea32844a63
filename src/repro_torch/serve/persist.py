"""Stage-A plan-cache persistence — warm restarts for the serving layer.

Port of ``repro/serve/persist.py``, in ``repro``'s format: the same
``FORMAT_VERSION``, the same pickle of numpy payloads, the same SHA-256
content fingerprints.  A snapshot saved by either package restores into
the other.

Two-stage compilation (:mod:`repro_torch.core.plans`) made the expensive,
graph-dependent half of an executor build — tile packing into the staged
block-sparse tensor — a cache entry.  That cache dies with the process,
so a restarted server pays the cold Stage-A build before its first
query.  This module serializes the *packed* Stage-A artifacts with enough
metadata to validate them, and restores them into a fresh
:class:`~repro_torch.core.plans.GraphPlanStore`, on the store's device.

What makes a snapshot valid for a placement is *content*, not object
identity: a snapshot carries a SHA-256 **fingerprint** of the placement
(node count, label vocabulary, edge triples, per-site edge ids) and the
loader re-keys entries against the new process's placement only when
the fingerprints match.  Any mismatch — another graph or partition,
another format version, a truncated file — returns ``False`` and leaves
the store untouched.

Bit-plane tiles are int32 tensors in the port and uint32 arrays in
``repro``, with the same bits: :func:`_encode` writes them as uint32 and
:func:`_decode` views them back, so both packages read each other's
snapshots with the right dtype.  ``staged_sharded`` entries (``repro``'s
per-site staging) restore only once the site-sharded backend is ported
(A12): until then the loader skips them and counts them in the store's
``skipped_on_restore``.

The on-disk format is a pickle of numpy payloads — treat snapshot files
like any other local cache: not an interchange format, and never to be
loaded from untrusted sources.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
from typing import Any

import numpy as np

import torch

from repro_torch.core.plans import GraphPlanStore
from repro_torch.graph.partition import Placement
from repro_torch.graph.structure import LabeledGraph
from repro_torch.kernels.frontier import ops as fops

FORMAT_VERSION = 1

# the products of tile packing; everything else in the store derives from
# these (or from the raw placement) without packing a tile
PERSISTED_KINDS = ("staged_graph", "staged_sharded")


# ---------------------------------------------------------------------------
# content fingerprints
# ---------------------------------------------------------------------------


def graph_fingerprint(graph: LabeledGraph) -> str:
    """SHA-256 of the graph's full content (nodes, vocabulary, edges)."""
    h = hashlib.sha256()
    h.update(np.int64(graph.n_nodes).tobytes())
    h.update("\x00".join(graph.labels).encode())
    for arr in (graph.src, graph.lbl, graph.dst):
        h.update(np.ascontiguousarray(arr, np.int64).tobytes())
    return h.hexdigest()


def placement_fingerprint(placement: Placement) -> str:
    """SHA-256 of the placement's content: the graph plus the per-site
    edge-id partition (replication included) — everything Stage A reads."""
    h = hashlib.sha256()
    h.update(graph_fingerprint(placement.graph).encode())
    h.update(np.int64(placement.n_sites).tobytes())
    for eids in placement.site_edges:
        h.update(np.ascontiguousarray(eids, np.int64).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# artifact <-> payload codecs (numpy payloads; device tensors rehydrate)
# ---------------------------------------------------------------------------


def _encode_offsets(offsets: dict) -> dict:
    return {
        key: (int(base), np.asarray(rows), np.asarray(cols))
        for key, (base, rows, cols) in offsets.items()
    }


def _encode(kind: str, artifact: Any) -> dict:
    if kind == "staged_graph":
        sg: fops.StagedGraph = artifact
        tiles = sg.tiles.cpu().numpy()
        if sg.tile_dtype == "uint32":
            tiles = tiles.view(np.uint32)  # repro's dtype, the same bits
        return {
            "n_nodes": sg.n_nodes, "v_pad": sg.v_pad, "block_size": sg.block_size,
            "tiles": tiles, "offsets": _encode_offsets(sg.offsets), "tile_dtype": sg.tile_dtype,
        }
    raise ValueError(f"unpersistable Stage-A kind {kind!r}")


def _decode(kind: str, payload: dict, device: torch.device) -> fops.StagedGraph:
    # snapshots written before the bit-plane store carry f32 tiles and no
    # tile_dtype
    if kind != "staged_graph":
        raise ValueError(f"unpersistable Stage-A kind {kind!r}")
    tiles = np.asarray(payload["tiles"])
    if tiles.dtype == np.uint32:
        tiles = tiles.view(np.int32)  # the port's holder of the same bits
    if not tiles.flags.writeable:  # unpickled from a read-only buffer
        tiles = tiles.copy()
    return fops.StagedGraph(
        n_nodes=payload["n_nodes"], v_pad=payload["v_pad"], block_size=payload["block_size"],
        tiles=torch.from_numpy(np.ascontiguousarray(tiles)).to(device),
        offsets=dict(payload["offsets"]),
        tile_dtype=payload.get("tile_dtype", "f32"),
    )


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------


def save_stage_a(
    store: GraphPlanStore, placement: Placement, path: str, stats_epoch: int = 0
) -> dict:
    """Snapshot every persistable Stage-A entry anchored to ``placement``
    (or its graph) to ``path``.  Returns a small manifest
    (``{"n_entries", "fingerprint", "stats_epoch"}``).  The write is
    atomic (tmp file + rename)."""
    entries = []
    for anchor_name, anchor in (("placement", placement), ("graph", placement.graph)):
        for portable_key, artifact, _epoch in store.export_entries(anchor):
            if portable_key[0] not in PERSISTED_KINDS:
                continue
            entries.append((anchor_name, portable_key, _encode(portable_key[0], artifact)))
    blob = {
        "format_version": FORMAT_VERSION,
        "fingerprint": placement_fingerprint(placement),
        "stats_epoch": int(stats_epoch),
        "entries": entries,
    }
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(blob, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return {
        "n_entries": len(entries),
        "fingerprint": blob["fingerprint"],
        "stats_epoch": blob["stats_epoch"],
    }


def load_stage_a(
    store: GraphPlanStore, placement: Placement, path: str, stats_epoch: int = 0
) -> bool:
    """Warm-restore a Stage-A snapshot into ``store``, on its device,
    re-keyed to ``placement`` at the caller's current ``stats_epoch``.

    Returns ``True`` only when the snapshot exists, parses, carries the
    current format version, and its content fingerprint matches this
    placement exactly; every other outcome returns ``False`` and leaves
    the store untouched.  ``staged_sharded`` entries are skipped and
    counted in ``store.skipped_on_restore`` (A12); the rest restore."""
    try:
        with open(path, "rb") as f:
            blob = pickle.load(f)
    except (OSError, pickle.UnpicklingError, EOFError, AttributeError):
        return False
    if not isinstance(blob, dict) or blob.get("format_version") != FORMAT_VERSION:
        return False
    if blob.get("fingerprint") != placement_fingerprint(placement):
        return False
    try:
        entries = blob["entries"]
        skipped = [key[0] for _, key, _ in entries if key[0] == "staged_sharded"]
        decoded = [
            (anchor_name, key, _decode(key[0], payload, store.device))
            for anchor_name, key, payload in entries
            if key[0] != "staged_sharded"
        ]
    except (KeyError, ValueError, TypeError):
        return False
    store.skipped_on_restore.update(skipped)
    for anchor_name, portable_key, artifact in decoded:
        anchor = placement if anchor_name == "placement" else placement.graph
        store.install_entry(portable_key, anchor, stats_epoch, artifact)
    return True
