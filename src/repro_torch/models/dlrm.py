"""DLRM (MLPerf config), arXiv:1906.00091: train, serve and retrieval
steps.

Port of ``repro/models/dlrm.py``: ``DLRMConfig``, ``init_params``,
``forward``, ``loss_fn``, ``make_train_step``, ``make_serve_step`` and
``make_retrieval_step``.  The hot path is the sparse embedding lookup,
which ``repro`` builds from ``jnp.take`` + ``jax.ops.segment_sum``; here
:func:`embedding_bag_local` runs ``kernels/embedbag/ops.py``'s
``embedding_bag``, that is kernel B6, the same function: each bag summed
in lookup order in the table's dtype, a bf16 sum rounded after every
lookup as ``segment_sum`` rounds it on the CPU.  Tables are replicated
or row-sharded per ``planner.embedding_placement`` (the paper's
replicate-vs-shard rule, ``DLRMConfig.table_modes``); on one card a
sharded table is looked up locally, as ``repro``'s off-mesh branch does.
On a mesh of ranks (``shd.use_mesh`` of a ``DeviceMesh``, one process a
rank) the steps are ``repro``'s 2-D program per rank: each rank holds
its row shard of every sharded table (:func:`shard_params`) and the
replicated ones whole, takes its block of the batch over the batch axes,
runs B6 on the lookups of its block that fall in its rows, one ``psum``
over the model axis a sharded table, and the step's output is gathered
over the batch axes; the retrieval step scores the rank's block of the
candidates over every axis, fitted as ``repro`` fits them, and gathers
the ranks' top 64.  :func:`param_specs` gives the tables' placements
under a layout's ``Rules`` for ``launch/``.  Training differentiates the bags through
``embedbag.embedding_bag_sorted_grad``: a table's gradient is B6 again
over the lookups sorted by row, dense (zero rows where no lookup
reads), as ``repro``'s transpose of ``jnp.take``; AdamW then moves every
row, as ``repro``'s does.  Over ranks the train step differentiates the
rank's program: the logits' gather gives each rank its block's
cotangent, B6's backward runs on the rank's lookups re-based to its
shard, and every gradient is the rank's block's part, reduced over the
axes the batch was blocked over by :func:`optimizer_for`'s optimizer
(ZeRO-1 AdamW by default); a row shard's gradient stays on its rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.core.planner import embedding_placement
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.kernels.embedbag import ops as embedbag_ops
from repro_torch.models.layers import normal
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.tree import value_and_grad

# Criteo-1TB per-field vocabulary sizes (MLPerf DLRM reference).
CRITEO_TABLE_SIZES = [
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
]


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-mlperf"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 128
    bot_mlp: tuple[int, ...] = (512, 256, 128)
    top_mlp: tuple[int, ...] = (1024, 1024, 512, 256, 1)
    table_sizes: tuple[int, ...] = tuple(CRITEO_TABLE_SIZES)
    multi_hot: int = 1  # lookups per field (bag size)
    optimizer: str = "adamw"
    dtype: Any = torch.float32
    table_dtype: Any = torch.bfloat16

    @property
    def padded_table_sizes(self) -> tuple[int, ...]:
        """Row counts padded to 512 so row-sharding divides any mesh axis
        (padding rows are never indexed: data ids stay < true size)."""
        return tuple(-(-r // 512) * 512 if r > 512 else r for r in self.table_sizes)

    def table_modes(self, n_devices: int, batch: int) -> list[str]:
        """Per-table replicate/shard decision via the paper's rule."""
        return [
            embedding_placement(rows, self.embed_dim, batch * self.multi_hot, n_devices).mode
            for rows in self.table_sizes
        ]


def _mlp_init(gen: torch.Generator, sizes, dtype) -> list[dict]:
    return [
        {"w": normal((a, b), 1.0 / math.sqrt(a), dtype, gen),
         "b": torch.zeros((b,), dtype=dtype, device=gen.device)}
        for a, b in zip(sizes[:-1], sizes[1:])
    ]


def _mlp_apply(layers: list[dict], x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i + 1 < len(layers):
            x = torch.relu(x)
    return x


def init_params(cfg: DLRMConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from one ``torch.Generator`` seeded with
    ``seed`` on ``device`` (None: the GPU): ``repro``'s tree and shapes,
    tables of ``padded_table_sizes`` rows drawn in f32 and cast to
    ``table_dtype`` a chunk at a time (dlrm-mlperf's largest table would
    take a 20 GB f32 temporary in one draw)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n_int = (cfg.n_sparse + 1) * cfg.n_sparse // 2  # upper-triangle pairs incl. dense
    top_in = n_int + cfg.bot_mlp[-1]
    return {
        "bot": _mlp_init(gen, (cfg.n_dense,) + cfg.bot_mlp, cfg.dtype),
        "top": _mlp_init(gen, (top_in,) + cfg.top_mlp, cfg.dtype),
        "tables": {
            f"t{i}": normal((rows, cfg.embed_dim), 1.0 / math.sqrt(cfg.embed_dim), cfg.table_dtype, gen)
            for i, rows in enumerate(cfg.padded_table_sizes)
        },
    }


def param_shapes(cfg: DLRMConfig) -> dict:
    """:func:`init_params`' tree as meta tensors (no allocation)."""
    n_int = (cfg.n_sparse + 1) * cfg.n_sparse // 2
    top_in = n_int + cfg.bot_mlp[-1]

    def mlp(sizes) -> list[dict]:
        return [{"w": torch.empty((a, b), dtype=cfg.dtype, device="meta"),
                 "b": torch.empty((b,), dtype=cfg.dtype, device="meta")}
                for a, b in zip(sizes[:-1], sizes[1:])]

    return {
        "bot": mlp((cfg.n_dense,) + cfg.bot_mlp),
        "top": mlp((top_in,) + cfg.top_mlp),
        "tables": {f"t{i}": torch.empty((rows, cfg.embed_dim), dtype=cfg.table_dtype, device="meta")
                   for i, rows in enumerate(cfg.padded_table_sizes)},
    }


def param_specs(cfg: DLRMConfig, rules: shd.Rules) -> dict:
    """The parameters' placements under ``rules``: ``repro``'s
    ``param_specs``.  A table the paper's rule shards (decided for the
    layout's device count, the product of its axis sizes, at a 65,536
    batch) is row-sharded over the model axis; the rest and the MLPs are
    replicated."""
    n_dev = math.prod(rules.axis_sizes.values())
    modes = cfg.table_modes(n_dev, 65536)
    tables = {f"t{i}": (rules.p_table_rows() if modes[i] == "shard" else (None, None))
              for i in range(cfg.n_sparse)}
    mlp_spec = [{"w": (None, None), "b": (None,)}]
    return {"bot": mlp_spec * len(cfg.bot_mlp), "top": mlp_spec * len(cfg.top_mlp), "tables": tables}


# ---------------------------------------------------------------------------
# EmbeddingBag on B6
# ---------------------------------------------------------------------------


def embedding_bag_local(
    table: torch.Tensor, idx: torch.Tensor, bag_ids: torch.Tensor, n_bags: int
) -> torch.Tensor:
    """EmbeddingBag (sum): bag ``bag_ids[i]`` adds ``table[idx[i]]``;
    (n_bags, D) in the table's dtype.  ``idx`` and ``bag_ids`` are (N,)
    int32 on the table's device."""
    return embedbag_ops.embedding_bag(table, idx, bag_ids, n_bags)


def table_row_shard(table: torch.Tensor, index: int, n_shards: int) -> torch.Tensor:
    """Rows ``[index·k, (index+1)·k)`` of ``table``, ``k = ⌈R / n_shards⌉``,
    past its R rows zero, as ``repro`` pads a table to ``k·n_shards`` rows
    before its shard_map splits it; the table itself for one shard."""
    if n_shards == 1:
        return table
    k = -(-table.shape[0] // n_shards)
    rows = table[index * k : (index + 1) * k]
    if rows.shape[0] == k:
        return rows.clone()
    pad = torch.zeros((k - rows.shape[0],) + tuple(table.shape[1:]), dtype=table.dtype, device=table.device)
    return torch.cat([rows, pad])


def shard_params(cfg: DLRMConfig, rules: shd.Rules, params: dict, batch: int) -> dict:
    """This rank's parameters on the installed mesh: each table that the
    paper's rule shards (``table_modes`` at the mesh's device count and
    ``batch``) cut to the rank's row shard over the model axis
    (:func:`table_row_shard`); the MLPs and the other tables as they are."""
    mesh = shd.get_mesh()
    if mesh is None or rules.model_axis is None:
        return params
    modes = cfg.table_modes(math.prod(shd.mesh_sizes(mesh).values()), batch)
    m = collectives.axis_index(mesh, rules.model_axis)
    tables = {k: table_row_shard(t, m, rules.model_size) if modes[int(k[1:])] == "shard" else t
              for k, t in params["tables"].items()}
    return {**params, "tables": tables}


def embedding_bag_sharded(table: torch.Tensor, idx: torch.Tensor, rules: shd.Rules) -> torch.Tensor:
    """A row-sharded table's EmbeddingBag over ``idx`` (B, hot): bag b
    sums ``table[idx[b]]``.  Off-mesh the lookup is local, as in
    ``repro``.  On the installed mesh (``repro``'s 2-D program): ``table``
    is this rank's row shard (:func:`table_row_shard` over the model
    axis), ``idx`` the whole batch, of which the rank takes its block
    (``collectives.batch_block``); B6 runs on the block's lookups that fall in
    the rank's rows, re-based to the shard (``repro`` masks the others
    to zero rows, which adds zeros; a bag no lookup visits is zero), and
    one ``psum`` over the model axis sums the shards.  Returns the
    block's bags, (hi - lo, D).  A shape-only run (meta ``idx``), which
    cannot count the rank's lookups, takes an even share of them,
    ⌈N/M⌉ of the block's N over the model axis's M ranks."""
    B, hot = idx.shape
    mesh = shd.get_mesh()
    if mesh is None or rules.model_axis is None:
        bag_ids = torch.arange(B, dtype=torch.int32, device=idx.device).repeat_interleave(
            hot, output_size=B * hot
        )
        return embedding_bag_local(table, idx.reshape(-1), bag_ids, B)
    lo, hi, _ = collectives.batch_block(rules, B)
    flat = idx[lo:hi].reshape(-1)
    k = table.shape[0]
    first = collectives.axis_index(mesh, rules.model_axis) * k
    mine = (flat >= first) & (flat < first + k)
    bag_ids = torch.arange(hi - lo, dtype=torch.int32, device=idx.device).repeat_interleave(
        hot, output_size=(hi - lo) * hot
    )
    if flat.is_meta:  # a shape-only run: an even share of the lookups falls in each shard
        n = -(-flat.shape[0] // rules.model_size)
        rows, bags = flat[:n], bag_ids[:n]
    else:
        rows, bags = flat[mine], bag_ids[mine]
    out = embedding_bag_local(table, (rows - first).to(torch.int32), bags, hi - lo)
    return collectives.psum(out, rules.model_axis, mesh)


# ---------------------------------------------------------------------------
# Forward / steps
# ---------------------------------------------------------------------------


def embedding_bags(cfg: DLRMConfig, rules: shd.Rules, params: dict, sparse: torch.Tensor) -> list:
    """The 26 bags of each row of ``sparse`` (B, n_sparse, multi_hot),
    one B6 launch a table, in the table's dtype; on a mesh, of the rank's
    block of rows (``collectives.batch_block``), the tables chosen by the rule at
    the mesh's device count."""
    B = sparse.shape[0]
    mesh = shd.get_mesh()
    modes = cfg.table_modes(1 if mesh is None else math.prod(shd.mesh_sizes(mesh).values()), B)
    lo, hi, _ = collectives.batch_block(rules, B)
    bag_ids = torch.arange(hi - lo, dtype=torch.int32, device=sparse.device).repeat_interleave(
        cfg.multi_hot, output_size=(hi - lo) * cfg.multi_hot
    )
    embs = []
    for i in range(cfg.n_sparse):
        table = params["tables"][f"t{i}"]
        if modes[i] == "shard":
            embs.append(embedding_bag_sharded(table, sparse[:, i, :], rules))
        else:
            embs.append(embedding_bag_local(table, sparse[lo:hi, i, :].reshape(-1), bag_ids, hi - lo))
    return embs


def forward(cfg: DLRMConfig, rules: shd.Rules, params: dict, batch: dict) -> torch.Tensor:
    """batch: dense (B, 13) float; sparse (B, 26, multi_hot) int32.
    Returns the logits (B,); on a mesh every rank computes its block of
    rows and returns the logits gathered over the batch axes."""
    lo, hi, axes = collectives.batch_block(rules, batch["dense"].shape[0])
    x_dense = _mlp_apply(params["bot"], batch["dense"][lo:hi])  # (B, 128)
    embs = embedding_bags(cfg, rules, params, batch["sparse"])
    # dot-interaction over [bottom-mlp output] + 26 embeddings
    feats = torch.stack([x_dense] + [e.float() for e in embs], dim=1)  # (B, 27, D)
    inter = torch.einsum("bnd,bmd->bnm", feats, feats)
    n = cfg.n_sparse + 1
    iu = torch.triu_indices(n, n, offset=1, device=feats.device)
    top_in = torch.cat([x_dense, inter[:, iu[0], iu[1]]], dim=-1)  # (B, 128 + 351)
    logits = _mlp_apply(params["top"], top_in)[:, 0]
    if not axes:
        return logits
    return collectives.gather_rows(logits, axes, batch["dense"].shape[0], shd.get_mesh())


def loss_fn(cfg: DLRMConfig, rules: shd.Rules, params: dict, batch: dict) -> torch.Tensor:
    """The mean logistic loss of the logits, in its stable form."""
    logit = forward(cfg, rules, params, batch)
    y = batch["labels"].float()
    return torch.mean(torch.clamp(logit, min=0) - logit * y + torch.log1p(torch.exp(-torch.abs(logit))))


def held_placements(cfg: DLRMConfig, rules: shd.Rules, batch: int) -> dict:
    """The placement each rank holds its parameters under on the installed
    mesh (:func:`shard_params` at ``batch``): a sharded table's rows over
    the model axis, every other leaf whole."""
    mesh = shd.get_mesh()
    n_dev = 1 if mesh is None else math.prod(shd.mesh_sizes(mesh).values())
    modes = cfg.table_modes(n_dev, batch)
    rows = rules.model_axis if mesh is not None and rules.model_axis else None
    mlp = [{"w": (None, None), "b": (None,)}]
    return {"bot": mlp * len(cfg.bot_mlp), "top": mlp * len(cfg.top_mlp),
            "tables": {f"t{i}": (rows if modes[i] == "shard" else None, None) for i in range(cfg.n_sparse)}}


def optimizer_for(cfg: DLRMConfig, rules: shd.Rules, params: dict, batch: int):
    """The train step's optimizer: ``cfg.optimizer`` on one card; on the
    installed mesh the rank's (``optimizer.on_ranks``, ZeRO-1 AdamW) for
    ``params`` as :func:`shard_params` cut them at ``batch``.
    Its ``init`` makes the rank's state."""
    if shd.get_mesh() is None:
        return opt_lib.get(cfg.optimizer)
    return opt_lib.on_ranks(cfg.optimizer, params, held_placements(cfg, rules, batch))


def make_train_step(cfg: DLRMConfig, rules: shd.Rules):
    """``train_step(params, opt_state, batch)`` -> (params, opt_state,
    loss): the loss's gradients, then one optimizer update (in place).  On
    the installed mesh each rank's gradients, of its block of the batch,
    are reduced over the axes the block was cut over, by the rank's
    optimizer (:func:`optimizer_for`; ZeRO-1)."""
    optimizer = opt_lib.get(cfg.optimizer)

    def train_step(params: dict, opt_state: dict, batch: dict):
        loss, grads = value_and_grad(lambda p: loss_fn(cfg, rules, p, batch))(params)
        if shd.get_mesh() is None:
            params, opt_state = optimizer.update(params, grads, opt_state)
        else:
            n = batch["dense"].shape[0]
            axes = collectives.batch_block(rules, n)[2]
            rank_opt = optimizer_for(cfg, rules, params, n)
            params, opt_state = rank_opt.update(params, grads, opt_state, [axes] * len(rank_opt.placements))
        return params, opt_state, loss

    return train_step


def make_serve_step(cfg: DLRMConfig, rules: shd.Rules):
    def serve_step(params: dict, batch: dict) -> torch.Tensor:
        return torch.sigmoid(forward(cfg, rules, params, batch))

    return serve_step


def make_retrieval_step(cfg: DLRMConfig, rules: shd.Rules, n_candidates: int | None = None):
    """retrieval_cand: one query (dense + sparse) scored against the
    candidate item embeddings, a batched dot; the top 64 as (scores,
    indices).

    On the installed mesh the candidates lie over every axis as
    ``repro`` fits ``P((batch axes…, model), None)``
    (``collectives.flat_block``: 62,500 of 1,000,000 a rank at (16, 16),
    over ``data``): a rank scores its block and takes its top 64 (all of
    a smaller block), the ranks' (score, global index) pairs are gathered
    over those axes (``all_gather``), and their top 64 is the answer on
    every rank, the one-card top 64 up to ties.  ``batch["candidates"]``
    is the whole tensor, or with ``n_candidates`` the rank's block of
    that many."""

    def retrieval_step(params: dict, batch: dict):
        dense, sparse, cand = batch["dense"], batch["sparse"], batch["candidates"]
        q = _mlp_apply(params["bot"], dense)  # (1, D)
        embs = [q[0]] + [e[0].float() for e in embedding_bags(cfg, rules, params, sparse[:1])]
        user = torch.stack(embs).mean(dim=0)  # (D,)
        if shd.get_mesh() is None:
            return torch.topk(cand @ user, 64)
        n = cand.shape[0] if n_candidates is None else n_candidates
        lo, hi, axes = collectives.flat_block(rules, n)
        if n_candidates is None:
            cand = cand[lo:hi]
        elif cand.shape[0] != hi - lo:
            raise ValueError(f"this rank's block of {n_candidates} candidates is [{lo}, {hi}), got {cand.shape[0]}")
        scores, idx = torch.topk(cand @ user, min(64, hi - lo))
        if hi - lo == n:  # the block is every candidate
            return scores, idx
        scores = collectives.all_gather(scores, axes)
        idx = collectives.all_gather(idx + lo, axes)
        top, pos = torch.topk(scores, 64)
        return top, idx[pos]

    return retrieval_step
