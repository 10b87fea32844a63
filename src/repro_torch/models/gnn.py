"""GNN architectures: GCN, SchNet, NequIP, EquiformerV2-style eSCN.

Port of ``repro/models/gnn.py``: the four configs, their ``*_init``,
forward and loss functions, ``INIT_FNS``, ``FWD_FNS``, ``LOSS_FNS``,
``make_gnn_train_step`` and ``make_gnn_serve_step``.  ``repro`` builds
its message passing on ``jax.ops.segment_sum`` over an edge-index ->
node scatter; here every
such scatter and every per-graph readout is :func:`scatter_sum`, which
runs kernel B6 (``kernels/embedbag/embedbag.py::embedding_bag_sorted``)
over the messages flattened to rows: the lookups are the edges sorted
stably by destination (:func:`sort_edges`, once per edge list and
forward, reused by every layer), so each node sums its messages in edge
order in f32, as ``segment_sum`` does on the CPU.  Masked edges
contribute what they do in ``repro``: the mask multiplies the message.
Under autograd the scatter's gradient is B6 too
(``embedbag.embedding_bag_sorted_grad``): each message row is one
lookup, so the transposed lookups are known without a sort, every edge
a bag reading its destination's cotangent row.

GCN does not build ``repro``'s per-edge message ``h[src] * coef`` (at
ogb_products 61.9 M x 47 f32, 11.6 GB): its coefficient factors as
``rsqrt(dout[src]) * rsqrt(din[dst])`` on the mask's edges, so a layer
gathers rows of the node table ``h * rsqrt(dout)`` on B6 (the body of
``embedbag.ops.gnn_aggregate`` on a sort made once) and scales the sums
by ``rsqrt(din)``.  The two differ by rounding only.  Its backward
gathers the cotangents on B6 over the kept edges sorted by source (one
sort per forward, shared by the layers and made at the first backward).

EquiformerV2's attention takes a segment max over each node's edges
(``jax.ops.segment_max``), a max that B6's sums cannot give; it is one
``scatter_reduce`` in plain PyTorch, on logits cut from the gradient
as ``repro`` cuts them (``stop_gradient``: the shift is for numerical
stability only, and the softmax does not depend on it).  Its per-edge
geometry (rotation, Wigner-D, radial basis) depends on the positions
only, so it is built once per forward rather than once per layer.

Distribution: under a mesh ``repro`` shards edges over every mesh axis
(``edge_shard_map``), replicates node state and parameters, and
combines the scatters with a ``psum``; without one, its wrapper is the
identity and ``rules`` selects nothing.  The port runs that program per
rank on the mesh ``shd.use_mesh`` installs (a ``DeviceMesh``, one
process a rank): each forward takes the rank's block of the edges
(:func:`edge_block`, blocked over the batch axes, then the model axis),
sorts and scatters them on B6, and :func:`scatter_sum` ``psum``-s each
scatter over those axes in ``repro``'s order, so every rank holds the
same node state; EquiformerV2's segment max is ``pmax``-ed likewise,
and the per-graph readouts, over replicated atoms, stay local.
:func:`equiformer_energy_big`, ``repro``'s mesh path from 150,000 nodes,
runs per rank too: node state sharded over the model axis and resting
sharded over the batch axes in bf16, edges over the batch axes, chunked
per-edge work with masked-``psum`` gathers and an online segment
softmax merged across ranks.

Gradients over ranks are ``repro``'s transposes of those ``shard_map``
bodies: the node state and the parameters that come into a rank's edge
block, the same on every rank, go through :func:`edge_enter`
(``collectives.enter``: their cotangents summed over the edge axes), a
scatter's ``psum`` passes its cotangent through, so every rank ends with
the whole gradient of every parameter and the train step reduces
nothing.  The large-graph path recomputes each chunk's contribution and
each layer under ``torch.utils.checkpoint``, as ``repro`` does under
``jax.checkpoint``; every rank recomputes the same collectives in the
same order.
"""

from __future__ import annotations

import dataclasses
import math
from functools import cache, lru_cache
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.kernels.embedbag.embedbag import embedding_bag_sorted_grad, transpose_lookups
from repro_torch.models.layers import normal, silu
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.tree import tree_map, value_and_grad


# ---------------------------------------------------------------------------
# The scatter: B6 over messages sorted by destination
# ---------------------------------------------------------------------------


class EdgeSort(NamedTuple):
    """A destination list sorted once: ``order`` (int32), the stable
    permutation that sorts it, and ``sorted_dst`` (int32), its values in
    that order; B6's lookups and bags.  ``dst`` (int32) is the list in
    edge order: the backward's lookups."""

    order: torch.Tensor
    sorted_dst: torch.Tensor
    dst: torch.Tensor


def sort_edges(dst: torch.Tensor) -> EdgeSort:
    """The stable sort of ``dst`` that :func:`scatter_sum` walks."""
    dst = dst.to(torch.int32)
    sorted_dst, order = torch.sort(dst, stable=True)
    return EdgeSort(order.to(torch.int32), sorted_dst, dst)


def _edge_axes(rules: shd.Rules) -> tuple[str, ...]:
    """The axes ``repro`` blocks edges over: the batch axes, then the model axis."""
    return tuple(rules.batch_axes) + ((rules.model_axis,) if rules.model_axis else ())


def edge_block(rules: shd.Rules, *edge_arrays: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """This rank's block of each edge array on the installed mesh
    (``repro``'s ``edge_shard_map`` in_specs ``P(axes)``, whose size must
    divide the edge count); the arrays themselves off-mesh."""
    mesh = shd.get_mesh()
    if mesh is None:
        return edge_arrays
    lo, hi = collectives.block_of(edge_arrays[0].shape[0], _edge_axes(rules), mesh, even=True)
    return tuple(a[lo:hi] for a in edge_arrays)


def edge_psum(x: torch.Tensor, rules: shd.Rules | None, op=collectives.psum) -> torch.Tensor:
    """``x`` reduced over the edge axes in ``repro``'s order (one
    ``all_reduce`` an axis) on the installed mesh; ``x`` off-mesh or
    without ``rules``."""
    mesh = shd.get_mesh()
    if mesh is None or rules is None:
        return x
    for ax in _edge_axes(rules):
        x = op(x, ax, mesh)
    return x


def edge_enter(x, rules: shd.Rules | None):
    """``x`` (a tensor or a tree of them: node state or parameters, the
    same on every rank) as it enters this rank's edge block on the
    installed mesh: ``collectives.enter`` over the edge axes, whose
    backward sums the ranks' cotangents (``repro``'s transpose of
    ``edge_shard_map``'s replicated inputs); ``x`` off-mesh."""
    mesh = shd.get_mesh()
    if mesh is None or rules is None:
        return x
    return collectives.enter_tree(x, _edge_axes(rules), mesh)


def scatter_sum(
    messages: torch.Tensor, edges: EdgeSort, n_nodes: int, rules: shd.Rules | None = None
) -> torch.Tensor:
    """``jax.ops.segment_sum(messages, dst, n_nodes)``: messages (E, ...)
    summed into (n_nodes, ...) by destination, on B6 over the messages
    as (E, prod(...)) rows, each node in edge order; nodes without an
    edge are zero.  Its gradient is B6 with one lookup a message row:
    edge e reads the cotangent row of ``dst[e]``.  With ``rules`` on a
    mesh, ``repro``'s distributed scatter: this rank's edges' sums,
    ``psum``-ed over the edge axes (:func:`edge_psum`)."""
    e = messages.shape[0]
    rows = messages.reshape(e, -1).contiguous()

    def transpose():
        return edges.dst, torch.arange(e, dtype=torch.int32, device=rows.device)

    out = embedding_bag_sorted_grad(rows, edges.order, edges.sorted_dst, n_nodes, transpose)
    return edge_psum(out, rules).reshape((n_nodes,) + tuple(messages.shape[1:]))


def _readout(atom_e: torch.Tensor, batch: dict) -> torch.Tensor:
    """Per-graph energies: the atoms' sum by ``graph_ids`` on B6 (the
    graph count from the target's shape), or the one graph's sum."""
    if "graph_ids" in batch:
        graphs = sort_edges(batch["graph_ids"])
        return scatter_sum(atom_e[:, None], graphs, batch["energy"].shape[0])[:, 0]
    return atom_e.sum()[None]


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def _mlp_init(gen: torch.Generator, sizes, dtype=torch.float32) -> list[dict]:
    return [
        {"w": normal((a, b), 1.0 / math.sqrt(a), dtype, gen),
         "b": torch.zeros((b,), dtype=dtype, device=gen.device)}
        for a, b in zip(sizes[:-1], sizes[1:])
    ]


def _mlp_apply(layers: list[dict], x: torch.Tensor, act=silu) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i + 1 < len(layers):
            x = act(x)
    return x


def gaussian_rbf(d: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    centers = torch.linspace(0.0, cutoff, n_rbf, device=d.device)
    gamma = n_rbf / cutoff
    out = torch.exp(-gamma * torch.square(d[..., None] - centers))
    env = 0.5 * (torch.cos(math.pi * torch.clip(d / cutoff, 0, 1)) + 1.0)  # cosine cutoff
    return out * env[..., None]


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return gen


def _edge_geometry(pos: torch.Tensor, src: torch.Tensor, dst: torch.Tensor):
    """(rel, d, rhat) of each edge: pos[src] - pos[dst], its length (with
    ``repro``'s 1e-12 under the root) and direction."""
    rel = pos[src.long()] - pos[dst.long()]
    d = torch.sqrt(torch.sum(rel * rel, -1) + 1e-12)
    return rel, d, rel / d[:, None]


# ===========================================================================
# GCN (Kipf & Welling) — arXiv:1609.02907
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_hidden: int = 16
    d_feat: int = 1433
    n_classes: int = 7
    optimizer: str = "adamw"


def gcn_init(cfg: GCNConfig, seed: int = 0, device=None) -> dict:
    sizes = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return {"layers": _mlp_init(_generator(seed, device), sizes)}


def gcn_forward(cfg: GCNConfig, rules: shd.Rules, params: dict, batch: dict) -> torch.Tensor:
    """Logits (N, n_classes): symmetric normalisation with self-loops.
    Degrees and each layer's aggregation are B6 launches (2 + n_layers);
    on a mesh over the rank's edges, each ``psum``-ed."""
    x = batch["node_feat"]
    n = x.shape[0]
    src, dst, emask = edge_block(rules, batch["edge_src"], batch["edge_dst"], batch["edge_mask"])
    ones = emask.to(torch.float32)[:, None]
    din = scatter_sum(ones, sort_edges(dst), n, rules)[:, 0] + 1.0
    dout = scatter_sum(ones, sort_edges(src), n, rules)[:, 0] + 1.0
    # the mask's edges sorted by destination, once for every layer; a
    # shape-only run (meta edges) keeps every padded edge, repro's masked shape
    kept_dst, kept_all = (dst, src) if emask.is_meta else (dst[emask], src[emask])
    kept = sort_edges(kept_dst)
    kept_src = kept_all[kept.order.long()].to(torch.int32)
    by_src = cache(lambda: transpose_lookups(kept_src, kept.sorted_dst))  # the backward's lookups
    s_out, s_in = torch.rsqrt(dout)[:, None], torch.rsqrt(din)[:, None]

    for i, layer in enumerate(params["layers"]):
        h = x @ layer["w"] + layer["b"]
        rows = edge_enter((h * s_out).contiguous(), rules)
        agg = edge_psum(embedding_bag_sorted_grad(rows, kept_src, kept.sorted_dst, n, by_src), rules) * s_in
        x = agg + h * torch.rsqrt(din * dout)[:, None]  # self loop
        if i + 1 < len(params["layers"]):
            x = torch.relu(x)
    return x


def gcn_loss(cfg: GCNConfig, rules: shd.Rules, params: dict, batch: dict) -> torch.Tensor:
    """Cross entropy of the logits over the nodes of ``train_mask``."""
    logits = gcn_forward(cfg, rules, params, batch)
    mask = batch["train_mask"].to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, batch["labels"].long()[:, None], dim=-1)[:, 0]
    return torch.sum((lse - gold) * mask) / torch.clamp(mask.sum(), min=1.0)


# ===========================================================================
# SchNet — arXiv:1706.08566
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_species: int = 32
    optimizer: str = "adamw"


def schnet_init(cfg: SchNetConfig, seed: int = 0, device=None) -> dict:
    gen = _generator(seed, device)
    inter = [
        {
            "filter": _mlp_init(gen, [cfg.n_rbf, cfg.d_hidden, cfg.d_hidden]),
            "in_proj": _mlp_init(gen, [cfg.d_hidden, cfg.d_hidden]),
            "out": _mlp_init(gen, [cfg.d_hidden, cfg.d_hidden, cfg.d_hidden]),
        }
        for _ in range(cfg.n_interactions)
    ]
    return {
        "embed": normal((cfg.n_species, cfg.d_hidden), 0.1, torch.float32, gen),
        "inter": inter,
        "readout": _mlp_init(gen, [cfg.d_hidden, cfg.d_hidden // 2, 1]),
    }


def schnet_energy(cfg: SchNetConfig, rules: shd.Rules, params: dict, batch: dict) -> torch.Tensor:
    """Energies (n_graphs,): one B6 launch per interaction, one readout."""
    species, pos = batch["species"], batch["positions"]
    src, dst, emask = edge_block(rules, batch["edge_src"], batch["edge_dst"], batch["edge_mask"])
    n = species.shape[0]
    edges = sort_edges(dst)
    h = params["embed"][species.long()]
    _, d, _ = _edge_geometry(pos, src, dst)
    rbf = gaussian_rbf(d, cfg.n_rbf, cfg.cutoff)
    mask = emask[:, None].to(h.dtype)

    for blk in params["inter"]:
        f0, f1 = edge_enter(blk["filter"], rules)
        ip = edge_enter(blk["in_proj"][0], rules)
        filt = silu(rbf @ f0["w"] + f0["b"]) @ f1["w"] + f1["b"]  # (E, D)
        hj = edge_enter(h, rules)[src.long()] @ ip["w"] + ip["b"]
        agg = scatter_sum(hj * filt * mask, edges, n, rules)
        h = h + _mlp_apply(blk["out"], agg)

    atom_e = _mlp_apply(params["readout"], h)[:, 0] * batch["node_mask"].to(h.dtype)
    return _readout(atom_e, batch)


def schnet_loss(cfg: SchNetConfig, rules: shd.Rules, params: dict, batch: dict) -> torch.Tensor:
    """The mean squared error of the energies."""
    e = schnet_energy(cfg, rules, params, batch)
    return torch.mean(torch.square(e - batch["energy"]))


# ===========================================================================
# NequIP (l_max = 2, Cartesian irreps) — arXiv:2101.03164
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    channels: int = 32
    l_max: int = 2  # fixed by the Cartesian implementation
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 32
    optimizer: str = "adamw"


_N_PATHS = 10  # radial-weighted tensor-product paths (see nequip_energy)


def nequip_init(cfg: NequIPConfig, seed: int = 0, device=None) -> dict:
    C = cfg.channels
    gen = _generator(seed, device)
    layers = [
        {
            "radial": _mlp_init(gen, [cfg.n_rbf, 32, _N_PATHS * C]),
            "mix_s": normal((C, C), 1.0 / math.sqrt(C), torch.float32, gen),
            "mix_v": normal((C, C), 1.0 / math.sqrt(C), torch.float32, gen),
            "mix_t": normal((C, C), 1.0 / math.sqrt(C), torch.float32, gen),
            "gate": _mlp_init(gen, [C, 2 * C]),
        }
        for _ in range(cfg.n_layers)
    ]
    return {
        "embed": normal((cfg.n_species, C), 0.5, torch.float32, gen),
        "layers": layers,
        "readout": _mlp_init(gen, [C, C, 1]),
    }


def _traceless(outer: torch.Tensor) -> torch.Tensor:  # (..., 3, 3) -> traceless symmetric part
    sym = 0.5 * (outer + outer.transpose(-1, -2))
    tr = torch.diagonal(sym, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return sym - tr * torch.eye(3, device=outer.device) / 3.0


def nequip_energy(cfg: NequIPConfig, rules: shd.Rules, params: dict, batch: dict) -> torch.Tensor:
    """Energies (n_graphs,): the scalar, vector and tensor messages of a
    layer concatenated into one (E, 13 C) row per edge, so one B6 launch
    per layer, and one readout."""
    species, pos = batch["species"], batch["positions"]
    src, dst, emask = edge_block(rules, batch["edge_src"], batch["edge_dst"], batch["edge_mask"])
    n = species.shape[0]
    C = cfg.channels
    edges = sort_edges(dst)
    s = params["embed"][species.long()]  # (N, C) scalars
    v = torch.zeros((n, C, 3), device=s.device)
    t = torch.zeros((n, C, 3, 3), device=s.device)
    _, d, rhat = _edge_geometry(pos, src, dst)
    T_edge = _traceless(rhat[:, :, None] * rhat[:, None, :])  # (E,3,3)
    rbf = gaussian_rbf(d, cfg.n_rbf, cfg.cutoff)
    rh = rhat[:, None, :]  # (E,1,3)
    isrc = src.long()

    for blk in params["layers"]:
        r0, r1 = edge_enter(blk["radial"], rules)
        w = (silu(rbf @ r0["w"] + r0["b"]) @ r1["w"] + r1["b"]).reshape(-1, _N_PATHS, C)
        w = w * emask[:, None, None].to(w.dtype)
        s_e, v_e, t_e = edge_enter((s, v, t), rules)
        sj, vj, tj = s_e[isrc], v_e[isrc], t_e[isrc]  # (E,C) (E,C,3) (E,C,3,3)
        # --- the 10 CG paths for l<=2 in Cartesian form -------------------
        m_s = (
            w[:, 0] * sj  # s⊗Y0→s
            + w[:, 1] * torch.einsum("ecx,ex->ec", vj, rhat)  # v⊗Y1→s
            + w[:, 2] * torch.einsum("ecxy,exy->ec", tj, T_edge)  # t⊗Y2→s
        )
        m_v = (
            w[:, 3, :, None] * sj[:, :, None] * rh  # s⊗Y1→v
            + w[:, 4, :, None] * vj  # v⊗Y0→v
            + w[:, 5, :, None] * torch.linalg.cross(vj, rh.expand(vj.shape), dim=-1)  # v⊗Y1→v
            + w[:, 6, :, None] * torch.einsum("ecxy,ey->ecx", tj, rhat)  # t⊗Y1→v
        )
        m_t = (
            w[:, 7, :, None, None] * sj[:, :, None, None] * T_edge[:, None]  # s⊗Y2→t
            + w[:, 8, :, None, None] * _traceless(vj[:, :, :, None] * rh[:, :, None, :])  # v⊗Y1→t
            + w[:, 9, :, None, None] * tj  # t⊗Y0→t
        )
        e = m_s.shape[0]
        msg = torch.cat([m_s, m_v.reshape(e, 3 * C), m_t.reshape(e, 9 * C)], dim=1)
        agg = scatter_sum(msg, edges, n, rules)
        ms, mv, mt = agg[:, :C], agg[:, C : 4 * C].reshape(n, C, 3), agg[:, 4 * C :].reshape(n, C, 3, 3)
        # node update: channel mixing per irrep + gated nonlinearity
        s_new = ms @ blk["mix_s"]
        v_new = torch.einsum("ncx,cd->ndx", mv, blk["mix_v"])
        t_new = torch.einsum("ncxy,cd->ndxy", mt, blk["mix_t"])
        gates = _mlp_apply(blk["gate"], s_new)
        gv, gt = torch.sigmoid(gates[:, :C]), torch.sigmoid(gates[:, C:])
        s = s + silu(s_new)
        v = v + v_new * gv[:, :, None]
        t = t + t_new * gt[:, :, None, None]

    atom_e = _mlp_apply(params["readout"], s)[:, 0] * batch["node_mask"].to(s.dtype)
    return _readout(atom_e, batch)


def nequip_loss(cfg: NequIPConfig, rules: shd.Rules, params: dict, batch: dict) -> torch.Tensor:
    """The mean squared error of the energies."""
    e = nequip_energy(cfg, rules, params, batch)
    return torch.mean(torch.square(e - batch["energy"]))


# ===========================================================================
# EquiformerV2-style eSCN — arXiv:2306.12059
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class EquiformerConfig:
    name: str = "equiformer-v2"
    n_layers: int = 12
    channels: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 32
    cutoff: float = 8.0
    n_species: int = 32
    optimizer: str = "adamw"

    @property
    def n_coef(self) -> int:
        return (self.l_max + 1) ** 2


# ---- real spherical harmonics up to l_max (recurrence-based) --------------


def real_sph_harm(vec, l_max: int, xp=torch):
    """Real, orthonormal spherical harmonics Y_{lm}(v̂) for unit vectors.

    vec: (..., 3) -> (..., (l_max+1)^2), ordering l-major, m from -l..l.
    Associated Legendre via the standard stable recurrences; azimuthal
    factors via Chebyshev recursion on (cosφ, sinφ).  ``xp`` selects the
    array namespace: torch, or numpy for the host-side Wigner basis."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    rho = xp.sqrt(x * x + y * y + 1e-20)
    ct = z  # cos θ (unit vectors)
    st = rho
    cphi, sphi = x / rho, y / rho

    # P_l^m(ct) for 0<=m<=l<=l_max (unnormalized, Condon–Shortley OMITTED)
    Pmm = {0: xp.ones_like(ct)}
    for m in range(1, l_max + 1):
        Pmm[m] = Pmm[m - 1] * (2 * m - 1) * st
    Plm = {}
    for m in range(0, l_max + 1):
        Plm[(m, m)] = Pmm[m]
        if m < l_max:
            Plm[(m + 1, m)] = ct * (2 * m + 1) * Pmm[m]
        for l in range(m + 2, l_max + 1):
            Plm[(l, m)] = (
                (2 * l - 1) * ct * Plm[(l - 1, m)] - (l + m - 1) * Plm[(l - 2, m)]
            ) / (l - m)

    cos_m = {0: xp.ones_like(cphi), 1: cphi}
    sin_m = {0: xp.zeros_like(sphi), 1: sphi}
    for m in range(2, l_max + 1):
        cos_m[m] = 2 * cphi * cos_m[m - 1] - cos_m[m - 2]
        sin_m[m] = 2 * cphi * sin_m[m - 1] - sin_m[m - 2]

    comps = []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            norm = math.sqrt(
                (2 * l + 1) / (4 * math.pi) * math.factorial(l - am) / math.factorial(l + am)
            )
            if m == 0:
                comps.append(norm * Plm[(l, 0)])
            elif m > 0:
                comps.append(math.sqrt(2) * norm * Plm[(l, m)] * cos_m[m])
            else:
                comps.append(math.sqrt(2) * norm * Plm[(l, am)] * sin_m[am])
    return xp.stack(comps, -1)


def _fibonacci_points(n: int) -> np.ndarray:
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5**0.5) * i
    return np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], -1
    )


_WIGNER_NPTS = 80


@lru_cache(maxsize=8)
def _wigner_basis_np(l_max: int):
    """Host-side (pure numpy): sample points P and pinv(Y(P)) for the
    per-edge D-regression."""
    pts = _fibonacci_points(_WIGNER_NPTS)
    Y = real_sph_harm(pts, l_max, xp=np)  # (npts, ncoef)
    return pts.astype(np.float32), np.linalg.pinv(Y).astype(np.float32)


def _wigner_basis(l_max: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    pts, pinv = _wigner_basis_np(l_max)
    return torch.from_numpy(pts).to(device), torch.from_numpy(pinv).to(device)


def edge_rotation(rhat: torch.Tensor) -> torch.Tensor:
    """Rotation matrix R_e with R_e @ rhat = ẑ (Rodrigues)."""
    z = torch.tensor([0.0, 1e-9, 1.0], device=rhat.device)
    z = z / torch.linalg.norm(z)
    v = torch.linalg.cross(rhat, z.expand(rhat.shape), dim=-1)
    c = rhat @ z
    s2 = torch.sum(v * v, -1)
    zero = torch.zeros_like(v[..., 0])
    vx = torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zero, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zero], -1),
    ], -2)
    eye = torch.eye(3, device=rhat.device).expand(vx.shape)
    factor = torch.where(s2 > 1e-12, (1 - c) / torch.clamp(s2, min=1e-12), torch.tensor(0.5, device=rhat.device))
    return eye + vx + (vx @ vx) * factor[..., None, None]


def wigner_d(rot: torch.Tensor, l_max: int, pts: torch.Tensor, pinv_y: torch.Tensor) -> torch.Tensor:
    """D(R) (ncoef, ncoef) per edge via Y(R·P) = D·Y(P) regression."""
    rp = torch.einsum("...ij,pj->...pi", rot, pts)  # rotated sample points
    y_rot = real_sph_harm(rp, l_max)  # (..., npts, ncoef)
    # D = Y(RP)^T · pinv(Y(P))^T : solve D Y(P)ᵀ = Y(RP)ᵀ
    return torch.einsum("...pc,pk->...ck", y_rot, pinv_y.T)


def _m_indices(l_max: int, m_max: int):
    """Coefficient indices for each |m| <= m_max: (pos list, neg list, l list)."""
    idx = {}
    for m in range(0, m_max + 1):
        pos, neg = [], []
        for l in range(m, l_max + 1):
            base = l * l + l  # m=0 position of degree l
            pos.append(base + m)
            neg.append(base - m)
        idx[m] = (np.array(pos), np.array(neg))
    return idx


def _so2_messages(cfg: EquiformerConfig, blk: dict, hj: torch.Tensor, Dw: torch.Tensor, rw: torch.Tensor,
                  midx) -> torch.Tensor:
    """eSCN's message of each edge, f32 (E, C, ncoef): the source's state
    ``hj`` rotated into the edge frame by ``Dw`` (E, ncoef, ncoef), the
    SO(2) linear map of each order m scaled by the radial weights ``rw``
    (E, m_max + 1, C), rotated back (Dᵀ = D⁻¹)."""
    g = torch.einsum("eck,eqk->ecq", hj, Dw)
    out = torch.zeros_like(g)
    for m in range(cfg.m_max + 1):
        pos_i, neg_i = midx[m]
        gp = g[:, :, pos_i] * rw[:, m][:, :, None]  # (E, C, n_lm)
        w1, w2 = blk["so2"][f"w{m}"][0], blk["so2"][f"w{m}"][1]
        if m == 0:
            out[:, :, pos_i] = (gp.reshape(gp.shape[0], -1) @ w1).reshape(gp.shape)
        else:
            gn = g[:, :, neg_i] * rw[:, m][:, :, None]
            fp, fn = gp.reshape(gp.shape[0], -1), gn.reshape(gn.shape[0], -1)
            out[:, :, pos_i] = (fp @ w1 - fn @ w2).reshape(gp.shape)
            out[:, :, neg_i] = (fp @ w2 + fn @ w1).reshape(gn.shape)
    return torch.einsum("ecq,eqk->eck", out, Dw)


def _radial(cfg: EquiformerConfig, blk: dict, rbf: torch.Tensor) -> torch.Tensor:
    """The radial weights (E, m_max + 1, C) of each edge's basis ``rbf``."""
    r0, r1 = blk["radial"]
    return (silu(rbf @ r0["w"] + r0["b"]) @ r1["w"] + r1["b"]).reshape(-1, cfg.m_max + 1, cfg.channels)


def _source_logits(blk: dict, hj_scal: torch.Tensor, em: torch.Tensor) -> torch.Tensor:
    """The large-graph path's attention logits (E, heads) from the source
    scalars alone (EquiformerV2's separate alpha projection), -1e30 on a
    masked edge."""
    a0, a1 = blk["attn"]
    logits = silu(hj_scal @ a0["w"] + a0["b"]) @ a1["w"] + a1["b"]
    return torch.where(em[:, None] > 0, logits, torch.tensor(-1e30, device=logits.device))


def _gated_update(cfg: EquiformerConfig, blk: dict, agg: torch.Tensor, repeats: torch.Tensor) -> torch.Tensor:
    """The per-degree channel mixing of the aggregate (n, C, ncoef) and
    its gated nonlinearity: the update added to the node state."""
    upd = torch.cat([
        torch.einsum("nck,cd->ndk", agg[:, :, l * l : (l + 1) * (l + 1)], blk["mix"][l])
        for l in range(cfg.l_max + 1)
    ], dim=-1)
    gates = _mlp_apply(blk["gate"], upd[:, :, 0]).reshape(agg.shape[0], cfg.channels, cfg.l_max + 1)
    return upd * torch.repeat_interleave(torch.sigmoid(gates), repeats, dim=-1, output_size=cfg.n_coef)


def equiformer_init(cfg: EquiformerConfig, seed: int = 0, device=None) -> dict:
    C = cfg.channels
    n_l = cfg.l_max + 1
    gen = _generator(seed, device)
    n_lm = {m: cfg.l_max + 1 - m for m in range(cfg.m_max + 1)}
    layers = [
        {
            "so2": {
                f"w{m}": normal((2, n_lm[m] * C, n_lm[m] * C), 1.0 / math.sqrt(n_lm[m] * C),
                                torch.float32, gen)
                for m in range(cfg.m_max + 1)
            },
            "radial": _mlp_init(gen, [cfg.n_rbf, 64, (cfg.m_max + 1) * C]),
            "attn": _mlp_init(gen, [C, 32, cfg.n_heads]),
            "mix": normal((n_l, C, C), 1.0 / math.sqrt(C), torch.float32, gen),
            "gate": _mlp_init(gen, [C, n_l * C]),
        }
        for _ in range(cfg.n_layers)
    ]
    return {
        "embed": normal((cfg.n_species, C), 0.5, torch.float32, gen),
        "layers": layers,
        "readout": _mlp_init(gen, [C, C, 1]),
    }


# repro's equiformer_energy dispatches to its mesh-only large-graph path
# from this many nodes, whose per-edge work runs in chunks of this many
# edges
_BIG_GRAPH_NODES = 150_000
_BIG_CHUNK = 32_768


def equiformer_atoms_big(cfg: EquiformerConfig, rules: shd.Rules, params: dict, batch: dict) -> torch.Tensor:
    """``repro``'s large-graph eSCN path (ogb_products / minibatch_lg
    scale), this rank's part of its ``shard_map`` body, on the installed
    mesh, up to the per-atom energies of the rank's resting rows: (n/M/D,)
    f32, global rows ``m·n/M + d·n/(M·D)`` on (``m``, ``d``) its model and
    batch coordinates.  :func:`equiformer_energy_big` sums them.  The
    batch's arrays are whole on every rank.

    * Node state: the rank's ``n_m = n/M`` rows ``[m·n_m, (m+1)·n_m)``
      over the model axis, bf16, resting on its ``n_m/D`` of them over the
      batch axes (``D`` their size) and ``all_gather``-ed each layer.
    * Edges: the rank's block over the batch axes, so every model rank of
      a data column sees the same edges, in chunks of :data:`_BIG_CHUNK`
      (``e_loc`` must divide into them, as ``repro``'s reshape needs).
      A row of a node array at an edge's index is a masked local take
      plus a ``psum`` over the model axis.
    * Attention: an online segment softmax per destination row (drop row
      ``n_m`` for the rows of other ranks): pass 1 the running max
      (``scatter_reduce(amax)``) and sum (B6) over the chunks, merged over
      the batch axes by ``pmax`` and ``psum``; pass 2 the normalised
      messages added chunk by chunk into a bf16 accumulator on B6 (bf16
      rows, rounded after every lookup), ``psum_scatter``-ed over the
      batch axes to the resting rows.
    * The mixing and the gate on the resting rows, the residual in bf16.

    B6 launches 2 × chunks × layers forward.  The per-edge geometry is
    made again in every chunk of every layer, as ``repro`` makes it: kept,
    it would be the (E, ncoef, ncoef) Wigner blocks of every edge at once.

    Under autograd each layer and each chunk's contribution run under
    ``torch.utils.checkpoint`` (``repro``'s ``jax.checkpoint``): a layer
    keeps its input, a chunk its output, and the backward recomputes them,
    collectives included, in the same order on every rank.  The
    parameters, the same on every rank, enter over every axis; a row
    gathered over the model axis enters it again (its cotangent summed
    over the model axis, then scattered to the rank that holds the row);
    pass 1's running max has no gradient; ``l`` merged over the batch
    axes enters them before pass 2 reads it on the rank's edges."""
    mesh = shd.get_mesh()
    if mesh is None or rules.model_axis is None:
        raise ValueError("equiformer_energy_big runs on an installed mesh with a model axis")
    species, pos = batch["species"], batch["positions"]
    n = species.shape[0]
    C, ncoef, heads = cfg.channels, cfg.n_coef, cfg.n_heads
    dev = pos.device
    pts, pinv_y = _wigner_basis(cfg.l_max, dev)
    midx = _m_indices(cfg.l_max, cfg.m_max)
    M, model = rules.model_size, rules.model_axis
    data_axes = tuple(rules.batch_axes)
    D = collectives.axis_size(mesh, data_axes) if data_axes else 1
    if n % M or (n // M) % D:
        raise ValueError(f"{n} nodes do not divide over the model axis ({M}) and then the batch axes ({D})")
    n_m = n // M
    n_rest = n_m // D
    lo = collectives.axis_index(mesh, model) * n_m
    d_idx = collectives.axis_index(mesh, data_axes) if data_axes else 0
    pos_m = pos[lo : lo + n_m]
    src, dst, emask = batch["edge_src"], batch["edge_dst"], batch["edge_mask"]
    if data_axes:
        e_lo, e_hi = collectives.block_of(src.shape[0], data_axes, mesh, even=True)
        src, dst, emask = src[e_lo:e_hi], dst[e_lo:e_hi], emask[e_lo:e_hi]
    e_loc = src.shape[0]
    n_chunks = max(e_loc // _BIG_CHUNK, 1)
    if e_loc % n_chunks:
        raise ValueError(f"{e_loc} edges a rank do not cut into {n_chunks} equal chunks")
    chunk = e_loc // n_chunks
    params = collectives.enter_tree(params, data_axes + (model,), mesh)
    grad = torch.is_grad_enabled()

    def ckpt(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if grad else fn(*args)

    def gather(arr_m: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Rows of a model-sharded (n_m, ...) array at global indices."""
        inr = (idx >= lo) & (idx < lo + n_m)
        rows = arr_m[torch.where(inr, idx - lo, 0)]
        rows = torch.where(inr.reshape(inr.shape + (1,) * (rows.dim() - 1)), rows,
                           torch.zeros((), dtype=rows.dtype, device=dev))
        return collectives.enter(collectives.psum(rows, model, mesh), model, mesh)

    def data_reduce(x: torch.Tensor, op) -> torch.Tensor:
        for ax in data_axes:
            x = op(x, ax, mesh)
        return x

    # each chunk: its edges, the destination row on this rank (n_m: the
    # drop row), and the sort B6 walks, made once for every layer
    chunks = []
    for c in range(n_chunks):
        s_idx, dd = src[c * chunk : (c + 1) * chunk].long(), dst[c * chunk : (c + 1) * chunk].long()
        inr = (dd >= lo) & (dd < lo + n_m)
        d_local = torch.where(inr, dd - lo, n_m)
        em = emask[c * chunk : (c + 1) * chunk].to(torch.float32)
        chunks.append((s_idx, dd, em, inr, d_local, sort_edges(d_local)))
    repeats = torch.tensor([2 * l + 1 for l in range(cfg.l_max + 1)], device=dev)

    rest = slice(lo + d_idx * n_rest, lo + (d_idx + 1) * n_rest)
    e0 = params["embed"][species[rest].long()].to(torch.bfloat16)
    h_rest = torch.cat([e0[:, :, None], torch.zeros((n_rest, C, ncoef - 1), dtype=torch.bfloat16, device=dev)], 2)

    def layer_fn(h_rest: torch.Tensor, blk: dict) -> torch.Tensor:
        h_m = collectives.all_gather(h_rest, data_axes, 0, mesh) if data_axes else h_rest
        h_scal = h_m[:, :, 0].float()

        def edge_logits(s_idx, em):
            return _source_logits(blk, gather(h_scal, s_idx), em)

        def edge_messages(s_idx, dd):
            rel = gather(pos_m, s_idx) - gather(pos_m, dd)
            dist = torch.sqrt(torch.sum(rel * rel, -1) + 1e-12)
            Dw = wigner_d(edge_rotation(rel / dist[:, None]), cfg.l_max, pts, pinv_y)
            rw = _radial(cfg, blk, gaussian_rbf(dist, cfg.n_rbf, cfg.cutoff))
            return _so2_messages(cfg, blk, gather(h_m, s_idx).float(), Dw, rw, midx)

        def stats(c: int, m_run: torch.Tensor):
            """Chunk c's running max (no gradient) and its softmax sums."""
            s_idx, dd, em, inr, d_local, order = chunks[c]
            logits = edge_logits(s_idx, em)
            m_chunk = torch.full((n_m + 1, heads), -1e30, device=dev).scatter_reduce(
                0, d_local[:, None].expand_as(logits), logits.detach(), "amax")[:n_m]
            m_new = torch.maximum(m_run, m_chunk)
            # another rank's destination: exp of -1e30, so that neither the
            # value nor the gradient (0 × exp of a huge number) overflows
            arg = torch.where(inr[:, None], logits - m_new[torch.clamp(d_local, max=n_m - 1)], -1e30)
            w_edge = torch.exp(arg) * em[:, None]
            return m_new, scatter_sum(w_edge, order, n_m + 1)[:n_m]

        def contrib(c: int, m_g: torch.Tensor, l_g: torch.Tensor):
            """Chunk c's normalised messages summed into bf16 rows."""
            s_idx, dd, em, inr, d_local, order = chunks[c]
            row = torch.clamp(d_local, max=n_m - 1)
            arg = torch.where(inr[:, None], edge_logits(s_idx, em) - m_g[row], -1e30)
            alpha = torch.exp(arg) / l_g[row] * em[:, None]
            w_c = torch.repeat_interleave(alpha, C // heads, dim=-1, output_size=C)
            rows = (edge_messages(s_idx, dd) * w_c[:, :, None]).to(torch.bfloat16)
            return scatter_sum(rows, order, n_m + 1)[:n_m]

        # pass 1: the softmax's running max and sum per destination row
        m_run = torch.full((n_m, heads), -1e30, device=dev)
        l_run = torch.zeros((n_m, heads), device=dev)
        for c in range(n_chunks):
            m_new, l_chunk = ckpt(stats, c, m_run)
            l_run = l_run * torch.exp(m_run - m_new) + l_chunk
            m_run = m_new
        # the flash merge across the batch axes, which saw other edges
        m_g = data_reduce(m_run, collectives.pmax)
        l_g = torch.clamp(data_reduce(l_run * torch.exp(m_run - m_g), collectives.psum), min=1e-20)
        l_g = collectives.enter(l_g, data_axes, mesh)

        # pass 2: the normalised messages into the bf16 accumulator
        acc = torch.zeros((n_m, C, ncoef), dtype=torch.bfloat16, device=dev)
        for c in range(n_chunks):
            acc = acc + ckpt(contrib, c, m_g, l_g)
        # combine across the batch axes and drop to the resting rows at once
        agg = (collectives.psum_scatter(acc, data_axes, 0, mesh) if data_axes else acc).float()
        del acc  # h_m stays: a chunk's backward recomputes from it
        return h_rest + _gated_update(cfg, blk, agg, repeats).to(torch.bfloat16)

    for blk in params["layers"]:
        h_rest = ckpt(layer_fn, h_rest, blk)

    nmask_rest = batch["node_mask"][rest]
    return _mlp_apply(params["readout"], h_rest[:, :, 0].float())[:, 0] * nmask_rest.to(torch.float32)


def equiformer_energy_big(cfg: EquiformerConfig, rules: shd.Rules, params: dict, batch: dict) -> torch.Tensor:
    """``repro``'s large-graph eSCN path on the installed mesh: the energy
    (1,) f32, the per-atom energies of :func:`equiformer_atoms_big`
    ``psum``-ed over every axis."""
    mesh = shd.get_mesh()
    e = collectives.psum(equiformer_atoms_big(cfg, rules, params, batch).sum(), rules.model_axis, mesh)
    for ax in rules.batch_axes:
        e = collectives.psum(e, ax, mesh)
    return e[None]


def equiformer_atoms_big_plain(cfg: EquiformerConfig, params: dict, batch: dict) -> torch.Tensor:
    """:func:`equiformer_atoms_big`'s function on one device in plain
    PyTorch, for tests and ``chip_smoke.py``: every node's energy (n,)
    f32, the whole graph at once (no mesh, no chunks, no kernel), the
    segment softmax over each destination's edges in one pass.  The node
    state is stored in bf16 where the large-graph path stores it (the
    embedding, each residual, the aggregate once summed) and the weighted
    messages are rounded to bf16 rows; the sums run in f32, where the
    path adds chunk by chunk into a bf16 accumulator.  Differentiable, the
    segment max cut from the gradient as the path cuts its running max,
    each layer recomputed in the backward (``torch.utils.checkpoint``):
    the card's reference for the path's gradient."""
    species, pos = batch["species"], batch["positions"]
    n = species.shape[0]
    C, ncoef, heads = cfg.channels, cfg.n_coef, cfg.n_heads
    dev = pos.device
    pts, pinv_y = _wigner_basis(cfg.l_max, dev)
    midx = _m_indices(cfg.l_max, cfg.m_max)
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    em = batch["edge_mask"].to(torch.float32)
    rel = pos[src] - pos[dst]
    dist = torch.sqrt(torch.sum(rel * rel, -1) + 1e-12)
    Dw = wigner_d(edge_rotation(rel / dist[:, None]), cfg.l_max, pts, pinv_y)
    rbf = gaussian_rbf(dist, cfg.n_rbf, cfg.cutoff)
    repeats = torch.tensor([2 * l + 1 for l in range(cfg.l_max + 1)], device=dev)
    e0 = params["embed"][species.long()].to(torch.bfloat16)
    h = torch.cat([e0[:, :, None], torch.zeros((n, C, ncoef - 1), dtype=torch.bfloat16, device=dev)], 2)

    def layer(h: torch.Tensor, blk: dict) -> torch.Tensor:
        logits = _source_logits(blk, h[:, :, 0].float()[src], em)
        z = torch.full((n, heads), -1e30, device=dev).scatter_reduce(
            0, dst[:, None].expand_as(logits), logits.detach(), "amax")
        ex = torch.exp(logits - z[dst]) * em[:, None]
        alpha = ex / torch.clamp(torch.zeros((n, heads), device=dev).index_add_(0, dst, ex), min=1e-20)[dst]
        w_c = torch.repeat_interleave(alpha, C // heads, dim=-1, output_size=C)
        rows = (_so2_messages(cfg, blk, h[src].float(), Dw, _radial(cfg, blk, rbf), midx) * w_c[:, :, None])
        agg = torch.zeros((n, C, ncoef), device=dev).index_add_(0, dst, rows.to(torch.bfloat16).float())
        return h + _gated_update(cfg, blk, agg.to(torch.bfloat16).float(), repeats).to(torch.bfloat16)

    for blk in params["layers"]:
        h = checkpoint(layer, h, blk, use_reentrant=False) if torch.is_grad_enabled() else layer(h, blk)
    return _mlp_apply(params["readout"], h[:, :, 0].float())[:, 0] * batch["node_mask"].to(torch.float32)


def equiformer_energy(cfg: EquiformerConfig, rules: shd.Rules, params: dict, batch: dict) -> torch.Tensor:
    """Energies (n_graphs,): ``repro``'s small-graph branch.  Per layer two
    B6 launches (the attention's denominators, then the messages as
    (E, C·ncoef) rows), and one readout; on a mesh over the rank's
    edges, the segment max ``pmax``-ed and each scatter ``psum``-ed.
    Where ``repro`` dispatches to :func:`equiformer_energy_big` (from
    150,000 nodes on a mesh with a model axis whose size divides them),
    so does this."""
    species, pos = batch["species"], batch["positions"]
    if (species.shape[0] >= _BIG_GRAPH_NODES and shd.get_mesh() is not None
            and rules.model_axis is not None and species.shape[0] % rules.model_size == 0):
        return equiformer_energy_big(cfg, rules, params, batch)
    src, dst, emask = edge_block(rules, batch["edge_src"], batch["edge_dst"], batch["edge_mask"])
    n = species.shape[0]
    C, ncoef = cfg.channels, cfg.n_coef
    dev = pos.device
    pts, pinv_y = _wigner_basis(cfg.l_max, dev)
    midx = _m_indices(cfg.l_max, cfg.m_max)
    edges = sort_edges(dst)
    idst, isrc = dst.long(), src.long()
    emask_f = emask.to(torch.float32)

    # per-edge geometry, the same in every layer
    _, d, rhat = _edge_geometry(pos, src, dst)
    D = wigner_d(edge_rotation(rhat), cfg.l_max, pts, pinv_y)  # (E,ncoef,ncoef)
    rbf = gaussian_rbf(d, cfg.n_rbf, cfg.cutoff)

    h = torch.zeros((n, C, ncoef), device=dev)
    h[:, :, 0] = params["embed"][species.long()]
    repeats = torch.tensor([2 * l + 1 for l in range(cfg.l_max + 1)], device=dev)

    for blk in params["layers"]:
        eblk = edge_enter({k: blk[k] for k in ("so2", "radial", "attn")}, rules)
        a0, a1 = eblk["attn"]
        msg = _so2_messages(cfg, eblk, edge_enter(h, rules)[isrc], D, _radial(cfg, eblk, rbf), midx)

        # graph attention on the scalar channel (segment softmax)
        scal = msg[:, :, 0]  # (E, C)
        logits = silu(scal @ a0["w"] + a0["b"]) @ a1["w"] + a1["b"]  # (E, heads)
        logits = torch.where(emask[:, None], logits, torch.tensor(-1e30, device=dev))
        # max-subtraction is for numerical stability only: cut from the
        # gradient, as repro's stop_gradient
        zmax = edge_psum(torch.full((n, cfg.n_heads), -math.inf, device=dev).scatter_reduce(
            0, idst[:, None].expand_as(logits), logits.detach(), "amax", include_self=False
        ), rules, collectives.pmax)
        ex = torch.exp(logits - zmax[idst]) * emask_f[:, None]
        denom = edge_enter(scatter_sum(ex, edges, n, rules), rules)  # summed, then read on the rank's edges
        alpha = ex / torch.clamp(denom[idst], min=1e-20)  # (E, heads)
        alpha_c = torch.repeat_interleave(alpha, C // cfg.n_heads, dim=-1, output_size=C)  # (E, C)
        msg = msg * alpha_c[:, :, None] * emask_f[:, None, None]
        agg = scatter_sum(msg, edges, n, rules)

        # per-degree channel mixing + gated nonlinearity
        h = h + _gated_update(cfg, blk, agg, repeats)

    atom_e = _mlp_apply(params["readout"], h[:, :, 0])[:, 0]
    atom_e = atom_e * batch["node_mask"].to(atom_e.dtype)
    return _readout(atom_e, batch)


def equiformer_loss(cfg: EquiformerConfig, rules: shd.Rules, params: dict, batch: dict) -> torch.Tensor:
    """The mean squared error of the energies."""
    e = equiformer_energy(cfg, rules, params, batch)
    return torch.mean(torch.square(e - batch["energy"]))


# ===========================================================================
# Train- and serve-step factories
# ===========================================================================

LOSS_FNS = {
    "gcn-cora": gcn_loss,
    "schnet": schnet_loss,
    "nequip": nequip_loss,
    "equiformer-v2": equiformer_loss,
}

INIT_FNS = {
    "gcn-cora": gcn_init,
    "schnet": schnet_init,
    "nequip": nequip_init,
    "equiformer-v2": equiformer_init,
}
FWD_FNS = {
    "gcn-cora": gcn_forward,
    "schnet": schnet_energy,
    "nequip": nequip_energy,
    "equiformer-v2": equiformer_energy,
}


def held_placements(params: dict):
    """The placement each rank holds a GNN's parameters under: every leaf
    whole (``repro`` replicates them)."""
    return tree_map(lambda t: (None,) * t.dim(), params)


def optimizer_for(cfg, rules: shd.Rules, params: dict):
    """The train step's optimizer: ``cfg.optimizer`` on one card; on the
    installed mesh the rank's (``optimizer.on_ranks``, ZeRO-1 AdamW).
    Its ``init`` makes the rank's state."""
    if shd.get_mesh() is None:
        return opt_lib.get(cfg.optimizer)
    return opt_lib.on_ranks(cfg.optimizer, params, held_placements(params))


def make_gnn_train_step(cfg, rules: shd.Rules):
    """``train_step(params, opt_state, batch)`` -> (params, opt_state,
    loss): the config's loss and its gradients, then one optimizer
    update (in place).  On the installed mesh each rank's gradients are
    already whole (the edge blocks' inputs enter over the edge axes), so
    the rank's optimizer (:func:`optimizer_for`; ZeRO-1)
    reduces none of them."""
    loss_fn = LOSS_FNS[cfg.name]
    optimizer = opt_lib.get(cfg.optimizer)

    def train_step(params: dict, opt_state: dict, batch: dict):
        loss, grads = value_and_grad(lambda p: loss_fn(cfg, rules, p, batch))(params)
        if shd.get_mesh() is None:
            params, opt_state = optimizer.update(params, grads, opt_state)
        else:
            rank_opt = optimizer_for(cfg, rules, params)
            params, opt_state = rank_opt.update(params, grads, opt_state, [()] * len(rank_opt.placements))
        return params, opt_state, loss

    return train_step


def make_gnn_serve_step(cfg, rules: shd.Rules):
    fwd = FWD_FNS[cfg.name]

    def serve_step(params: dict, batch: dict) -> torch.Tensor:
        return fwd(cfg, rules, params, batch)

    return serve_step
