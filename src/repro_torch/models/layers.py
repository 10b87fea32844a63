"""Transformer building blocks: RMSNorm, RoPE, GQA attention (qk-norm
optional), chunked flash-style attention, decode attention on kernel B7,
the SwiGLU FFN and the MoE layer.

Port of ``repro/models/layers.py``.  The losses
(:func:`cross_entropy`, :func:`chunked_cross_entropy`) train the LMs;
every layer is differentiable by autograd.  Everything is functional:
``init_*`` build dictionaries of tensors, ``apply_*`` consume them.
``rules`` is taken where ``repro`` takes it; its constraints are the
identity.

:func:`apply_moe` on an installed ``DeviceMesh`` with a model axis runs
``repro``'s expert-parallel ``shard_map`` body per rank: the experts
over the model axis, the tokens over (batch axes, model), a sort-based
dispatch with static capacities (GShard drops) and two ``all_to_all``s
(``dist/collectives.py``); with ``fsdp`` (kimi-k2) each rank rests on
its experts' d_ff block over the batch axes and gathers it for the
layer.  A rank holds its share of the experts (:func:`moe_shard`).
:func:`moe_capacity_plain` is its one-card reference: the kept
assignments, worked out from the global routing, summed.  Its gradient
over ranks runs the three ``all_to_all``s in reverse, gives the dropped
slots zero, returns an ``fsdp`` gather's gradient to the rank's d_ff
slice as a ``psum_scatter``, and sums the cotangents of the inputs that
every rank of an axis holds alike (x, the router) over the axes the
rank's tokens were cut over (``collectives.enter``).

:class:`TensorParallel` (from :func:`tensor_parallel`) is a rank's
share of an LM's dense layers on an installed mesh with a model axis,
``repro``'s placements fitted (``dist/sharding.py``'s table): q, k and v
column-parallel, k and v gathered whole (``repro`` constrains them
whole), q's heads over the model axis where ``act/bthd`` fits them (else
gathered), ``wo`` row-parallel then a ``psum``; the SwiGLU FFN
column-parallel then row-parallel, then a ``psum``
(:func:`apply_mlp`); the loss over the rank's vocab columns, its max by
``pmax`` and its sums by ``psum`` (:func:`chunked_cross_entropy`).  A
dimension the model axis does not divide stays whole, and a layer whose
blocks are all whole runs the one-card code.  Where a replicated value
meets column-parallel weights it passes ``collectives.enter``, so its
cotangent (and the norms' gradients behind it) is summed over the model
axis.

Promotions follow ``repro``'s: norms and RoPE compute in f32 and cast
back to the input's dtype; products of bf16 tensors are bf16.
:func:`decode_attention` runs B7 (``kernels/decode_attn/ops.py``), where
``repro``'s layer is a plain softmax: the same function, an online
softmax that rounds p to V's dtype relative to another running max, so
they agree to B7's tolerances (2e-5 in f32, 2e-2 in bf16).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.kernels.decode_attn import ops as decode_ops

# elements drawn at once by :func:`normal`: bounds its f32 temporary at 1 GiB
INIT_CHUNK = 1 << 28

_MASKED = -1e30


def normal(shape, std: float, dtype: torch.dtype, gen: torch.Generator) -> torch.Tensor:
    """A tensor of ``shape`` on ``gen``'s device, N(0, std²) drawn in f32
    from ``gen`` and cast to ``dtype``, as ``repro`` casts its f32 draws;
    drawn :data:`INIT_CHUNK` elements at a time, so the f32 temporary
    stays bounded however large the tensor (a 20 GB embedding table)."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    flat = out.view(-1)
    for lo in range(0, flat.numel(), INIT_CHUNK):
        hi = min(lo + INIT_CHUNK, flat.numel())
        flat[lo:hi] = torch.randn(hi - lo, generator=gen, device=gen.device) * std
    return out


# ---------------------------------------------------------------------------
# Norms / RoPE / misc
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e6) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


class Block(NamedTuple):
    """The indices ``[lo, hi)`` of a dimension of ``n`` that a rank holds."""

    lo: int
    hi: int
    n: int

    @property
    def whole(self) -> bool:
        return self.hi - self.lo == self.n

    def cut(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x``'s indices ``[lo, hi)`` along ``dim``; ``x`` itself when the
        block is whole."""
        return x if self.whole else x.narrow(dim, self.lo, self.hi - self.lo)


class TensorParallel(NamedTuple):
    """A rank's blocks of an LM's dense layers over the model axis
    (:func:`tensor_parallel`).  ``axis`` is the model axis when some block
    is cut, else ``None``: every block whole, no collective."""

    axis: str | None
    q: Block  # wq's columns held
    kv: Block  # wk's and wv's columns held
    heads: Block  # the q heads the rank's attention runs
    groups: Block  # the kv groups those heads read
    o: Block  # wo's rows held
    ff: Block  # w_gate's and w_up's columns, w_down's rows
    vocab: Block  # embed's rows, lm_head's columns


def tensor_parallel(rules: shd.Rules, d_model: int, n_q: int, n_kv: int, d_head: int, d_ff: int, vocab: int,
                    whole_heads: bool = False) -> TensorParallel:
    """This rank's :class:`TensorParallel` on the installed mesh: each
    parameter's block under ``rules``' placement fitted to its global
    shape (``collectives.fitted_block``), and q's heads under ``act/bthd``
    fitted.  The heads stay whole (q gathered after its column-parallel
    projection) where ``act/bthd`` does not divide them, where they would
    straddle kv groups unevenly, or with ``whole_heads`` (the
    sequence-sharded decode, whose ranks each attend with every head).
    Every block whole off-mesh or without a model axis."""
    hq, hkv = n_q * d_head, n_kv * d_head

    def blk(spec, shape, dim) -> Block:
        lo, hi, _ = collectives.fitted_block(spec, shape, dim)
        return Block(lo, hi, shape[dim])

    if shd.get_mesh() is None or rules.model_axis is None:
        parts = [Block(0, n, n) for n in (hq, hkv, n_q, n_kv, hq, d_ff, vocab)]
        return TensorParallel(None, *parts)
    heads = Block(0, n_q, n_q) if whole_heads else blk(rules.act_bthd(), (1, 1, n_q, d_head), 2)
    groups = _kv_groups(heads, n_q // n_kv, n_kv)
    if groups is None:
        heads, groups = Block(0, n_q, n_q), Block(0, n_kv, n_kv)
    tp = TensorParallel(
        rules.model_axis,
        blk(rules.p_attn_in(), (1, d_model, hq), 2), blk(rules.p_attn_in(), (1, d_model, hkv), 2), heads, groups,
        blk(rules.p_attn_out(), (1, hq, d_model), 1), blk(rules.p_mlp_in(), (1, d_model, d_ff), 2),
        blk(rules.p_embed(), (vocab, d_model), 0))
    cut = not all(b.whole for b in (tp.q, tp.kv, tp.heads, tp.o, tp.ff, tp.vocab))
    return tp if cut else tp._replace(axis=None)


def _kv_groups(heads: Block, r: int, n_kv: int) -> Block | None:
    """The kv groups q heads ``heads`` read (r heads a group): whole groups,
    or one group the heads lie in; ``None`` when they straddle groups
    unevenly."""
    if heads.lo % r == 0 and (heads.hi - heads.lo) % r == 0:
        return Block(heads.lo // r, heads.hi // r, n_kv)
    if heads.lo // r == (heads.hi - 1) // r:
        return Block(heads.lo // r, heads.lo // r + 1, n_kv)
    return None


def _enter(x: torch.Tensor, tp: TensorParallel | None) -> torch.Tensor:
    """``x`` (the same on every rank of the model axis) about to meet the
    rank's blocks: its cotangent summed over the axis."""
    return x if tp is None or tp.axis is None else collectives.enter(x, tp.axis)


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, rules: shd.Rules, n_valid: int | None = None
) -> torch.Tensor:
    """Token-mean cross entropy in f32; ``n_valid`` masks the vocab's
    padding columns (those added so the vocab shards evenly)."""
    logits = logits.float()
    V = logits.shape[-1]
    if n_valid is not None and n_valid < V:
        pad_mask = torch.arange(V, device=logits.device) >= n_valid
        logits = torch.where(pad_mask, _MASKED, logits)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.long()[..., None], dim=-1)[..., 0]
    return torch.mean(lse - gold)


def _shard_chunks(v_shard: int, target: int = 1024) -> int:
    """Largest power-of-two chunk count <= 16 that divides v_shard."""
    for n2 in (16, 8, 4, 2):
        if v_shard % n2 == 0 and v_shard // n2 >= 128:
            return n2
    return 1


def chunked_cross_entropy(
    x: torch.Tensor, lm_head: torch.Tensor, labels: torch.Tensor, rules: shd.Rules, n_valid: int,
    tp: TensorParallel | None = None,
) -> torch.Tensor:
    """Token-mean cross entropy computed in vocab chunks, ``repro``'s
    layout: the head viewed as (D, M, n2, vc2), M the model axis's shard
    count (1 on one card), the chunks splitting each shard's columns.
    Two passes over the chunks: the running max (no gradient, as
    ``repro``'s ``stop_gradient``), then the exp-sums and the gold logit,
    each chunk's body under ``torch.utils.checkpoint`` (``repro``'s
    ``jax.checkpoint``), so neither pass keeps a chunk's logits and the
    (B, S, V) logits never exist.  Running statistics are (B, S) f32.

    With ``tp`` cutting the vocab, ``lm_head`` is the rank's shard of
    columns ``[tp.vocab.lo, tp.vocab.hi)``: the rank walks its own
    chunks, the running max is ``pmax``-ed and the exp-sums and gold
    logits ``psum``-ed over the model axis.  A vocab a cutting ``tp``
    leaves whole (one the model axis does not divide) is one shard."""
    B, S, D = x.shape
    V = lm_head.shape[1]
    sharded = tp is not None and not tp.vocab.whole
    M = 1 if tp is not None and tp.axis is not None else max(rules.model_size, 1)
    assert V % M == 0, (V, M)
    v_shard = V // M
    n2 = _shard_chunks(v_shard)
    vc2 = v_shard // n2
    if sharded:
        x = _enter(x, tp)
    heads = lm_head.reshape(D, M, n2, vc2)
    # global column id of (m, ci, c2) is m*v_shard + ci*vc2 + c2 (+ the shard's offset)
    m_ids = torch.arange(M, device=x.device)[:, None] * v_shard
    if sharded:
        m_ids = m_ids + tp.vocab.lo
    c2_ids = torch.arange(vc2, device=x.device)[None, :]
    labels = labels.long()

    def logits_chunk(ci: int):
        lg = torch.einsum("bsd,dmv->bsmv", x, heads[:, :, ci]).float()
        col = m_ids + ci * vc2 + c2_ids  # (M, vc2)
        return torch.where(col[None, None] < n_valid, lg, _MASKED), col

    with torch.no_grad():
        m = torch.full((B, S), -math.inf, device=x.device)
        for ci in range(n2):
            m = torch.maximum(m, logits_chunk(ci)[0].amax(dim=(-1, -2)))
        if sharded:
            m = collectives.pmax(m, tp.axis)

    def chunk_contrib(ci: int):
        lg, col = logits_chunk(ci)
        se = torch.exp(lg - m[..., None, None]).sum(dim=(-1, -2))
        gold = torch.where(col[None, None] == labels[..., None, None], lg, 0.0).sum(dim=(-1, -2))
        return se, gold

    se = torch.zeros((B, S), device=x.device)
    gold = torch.zeros((B, S), device=x.device)
    for ci in range(n2):
        se_c, gold_c = checkpoint(chunk_contrib, ci, use_reentrant=False)
        se, gold = se + se_c, gold + gold_c
    if sharded:
        se, gold = collectives.psum(torch.stack([se, gold]), tp.axis)
    lse = m + torch.log(se)
    return torch.mean(lse - gold)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def chunked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
    q_chunk: int = 512, kv_chunk: int = 1024, q_offset: int = 0,
) -> torch.Tensor:
    """Flash-style chunked attention in plain PyTorch, ``repro``'s loop
    for loop.  q: (B, Sq, H, Dh); k, v: (B, Skv, G, Dh) with H = G·r
    (GQA).  An online softmax over kv chunks keeps the score buffer at
    (B, G, r, q_chunk, kv_chunk); masked scores are -1e30, statistics and
    the accumulator f32, p rounded to V's dtype before P·V."""
    B, Sq, H, Dh = q.shape
    _, Skv, G, _ = k.shape
    r = H // G
    scale = 1.0 / math.sqrt(Dh)
    dev = q.device
    q = q.reshape(B, Sq, G, r, Dh)

    n_q = -(-Sq // q_chunk)
    n_kv = -(-Skv // kv_chunk)
    q_pad = n_q * q_chunk - Sq
    kv_pad = n_kv * kv_chunk - Skv
    if q_pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, q_pad))
    if kv_pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, kv_pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, kv_pad))

    kc = k.reshape(B, n_kv, kv_chunk, G, Dh)
    vc = v.reshape(B, n_kv, kv_chunk, G, Dh)
    qc = q.reshape(B, n_q, q_chunk, G, r, Dh)
    kv_valid = (torch.arange(n_kv * kv_chunk, device=dev) < Skv).reshape(n_kv, kv_chunk)

    outs = []
    for qi in range(n_q):
        qblk = qc[:, qi]  # (B, qc, G, r, Dh)
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, G, r, q_chunk), -math.inf, device=dev)
        l = torch.zeros((B, G, r, q_chunk), device=dev)
        acc = torch.zeros((B, G, r, q_chunk, Dh), device=dev)
        for ki in range(n_kv):
            kblk, vblk = kc[:, ki], vc[:, ki]  # (B, kc, G, Dh)
            s = torch.einsum("bqgrd,bkgd->bgrqk", qblk, kblk).float() * scale
            mask = kv_valid[ki][None, :]
            if causal:
                kv_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
                mask = mask & (q_pos[:, None] >= kv_pos[None, :])
            s = torch.where(mask, s, _MASKED)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bkgd->bgrqd", p.to(vblk.dtype), vblk
            ).float()
            m = m_new
        outs.append((acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype))  # (B, G, r, qc, Dh)

    out = torch.stack(outs, dim=1).movedim(4, 2)  # (B, n_q, qc, G, r, Dh)
    out = out.reshape(B, n_q * q_chunk, G, r, Dh)[:, :Sq]
    return out.reshape(B, Sq, H, Dh)


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: torch.Tensor, groups: Block | None = None
) -> torch.Tensor:
    """Single-position attention against the KV cache, on B7.  q: (B, 1,
    H, Dh); k, v: (B, S, G, Dh), contiguous; kv_len: the valid prefix, a
    () int32 tensor on q's device; ``groups``: the kv groups q's heads
    read (a tensor-parallel rank's, read in place; ``None``: all).  B7's
    plain version walks blocks of ``gcd(S, 512)`` positions (its block
    must divide S); the kernel picks its own tiles and splits."""
    B, _, H, Dh = q.shape
    offset = {} if groups is None or groups.whole else {"kv_head_offset": groups.lo, "kv_heads": groups.hi - groups.lo}
    out = decode_ops.decode_attention(
        q.reshape(B, H, Dh), k, v, kv_len, block_kv=math.gcd(k.shape[1], 512), **offset
    )
    return out.reshape(B, 1, H, Dh)


# ---------------------------------------------------------------------------
# Attention block (projections + norms + rope)
# ---------------------------------------------------------------------------


def init_attention(
    gen: torch.Generator, d_model: int, n_q: int, n_kv: int, d_head: int, qk_norm: bool,
    dtype: torch.dtype, lead: tuple[int, ...] = (),
) -> dict:
    """One attention block's weights, each with the leading dims ``lead``
    (``(n_layers,)`` for the stacked layers ``repro``'s ``vmap`` builds)."""
    sd = 1.0 / math.sqrt(d_model)
    p = {
        "wq": normal(lead + (d_model, n_q * d_head), sd, dtype, gen),
        "wk": normal(lead + (d_model, n_kv * d_head), sd, dtype, gen),
        "wv": normal(lead + (d_model, n_kv * d_head), sd, dtype, gen),
        "wo": normal(lead + (n_q * d_head, d_model), sd, dtype, gen),
    }
    if qk_norm:
        p["q_norm"] = torch.ones(lead + (d_head,), dtype=torch.float32, device=gen.device)
        p["k_norm"] = torch.ones(lead + (d_head,), dtype=torch.float32, device=gen.device)
    return p


def apply_attention_proj(
    p: dict, x: torch.Tensor, n_q: int, n_kv: int, d_head: int, positions: torch.Tensor,
    rules: shd.Rules, rope_theta: float = 1e6, tp: TensorParallel | None = None,
):
    """QKV projection + qk-norm + rope.  Returns (q, k, v).  With ``tp``
    the projections are the rank's column blocks: k and v are gathered
    whole over the model axis, q to its heads ``tp.heads`` (gathered whole
    where its columns do not match them)."""
    B, S, _ = x.shape
    if tp is None or tp.q.whole:  # (k's columns divide wherever q's do)
        q = (x @ p["wq"]).reshape(B, S, n_q, d_head)
        k = (x @ p["wk"]).reshape(B, S, n_kv, d_head)
        v = (x @ p["wv"]).reshape(B, S, n_kv, d_head)
        q_norm, k_norm = p.get("q_norm"), p.get("k_norm")
    else:
        x = _enter(x, tp)
        q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
        if not tp.kv.whole:
            k, v = (collectives.all_gather(t, tp.axis, 2) for t in (k, v))
        if (tp.q.lo, tp.q.hi) != (tp.heads.lo * d_head, tp.heads.hi * d_head):
            q = collectives.all_gather(q, tp.axis, 2)
        q = q.reshape(B, S, tp.heads.hi - tp.heads.lo, d_head)
        k, v = k.reshape(B, S, n_kv, d_head), v.reshape(B, S, n_kv, d_head)
        # replicated, applied to values whose cotangents are the rank's part
        q_norm, k_norm = (None if n not in p else _enter(p[n], tp) for n in ("q_norm", "k_norm"))
    if q_norm is not None:
        q = rmsnorm(q, q_norm)
        k = rmsnorm(k, k_norm)
    return rope(q, positions, rope_theta), rope(k, positions, rope_theta), v


def lm_logits(x: torch.Tensor, lm_head: torch.Tensor, tp: TensorParallel | None = None) -> torch.Tensor:
    """``x @ lm_head``: the logits over the padded vocab.  With ``tp``
    cutting the vocab, the rank's columns gathered whole over the model
    axis (``repro``'s ``act/logits`` shards them; its step returns them
    whole)."""
    if tp is None or tp.vocab.whole:
        return x @ lm_head
    return collectives.all_gather(_enter(x, tp) @ lm_head, tp.axis, x.dim() - 1)


def attention_out(o: torch.Tensor, wo: torch.Tensor, tp: TensorParallel | None = None) -> torch.Tensor:
    """The attention output (B, S, heads·Dh) through ``wo``.  With ``tp``
    cutting ``wo``'s rows: the rank's rows of ``o`` (all of it when its
    heads are the rank's) against its block, then a ``psum`` over the
    model axis."""
    if tp is None or tp.o.whole:
        return o @ wo
    if o.shape[-1] != tp.o.hi - tp.o.lo:
        o = tp.o.cut(o, o.dim() - 1)
    return collectives.psum(o @ wo, tp.axis)


# ---------------------------------------------------------------------------
# FFN (dense SwiGLU)
# ---------------------------------------------------------------------------


def init_mlp(
    gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype, lead: tuple[int, ...] = ()
) -> dict:
    si, so = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return {
        "w_gate": normal(lead + (d_model, d_ff), si, dtype, gen),
        "w_up": normal(lead + (d_model, d_ff), si, dtype, gen),
        "w_down": normal(lead + (d_ff, d_model), so, dtype, gen),
    }


def apply_mlp(p: dict, x: torch.Tensor, rules: shd.Rules, tp: TensorParallel | None = None) -> torch.Tensor:
    """The SwiGLU FFN.  With ``tp`` cutting d_ff: the rank's columns of
    ``w_gate`` and ``w_up`` and rows of ``w_down`` (``act/ffn``), the
    partial outputs ``psum``-ed over the model axis."""
    if tp is None or tp.ff.whole:
        return (silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    x = _enter(x, tp)
    return collectives.psum((silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"], tp.axis)


# ---------------------------------------------------------------------------
# MoE (one card: top-k routing, SwiGLU experts on their routed rows)
# ---------------------------------------------------------------------------


def init_moe(
    gen: torch.Generator, d_model: int, d_ff: int, n_experts: int, dtype: torch.dtype,
    lead: tuple[int, ...] = (),
) -> dict:
    """The router (f32) and the experts' three SwiGLU tensors (E, D, F) /
    (E, F, D) in ``dtype``, each with the leading dims ``lead``."""
    si, so = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return {
        "router": normal(lead + (d_model, n_experts), si, torch.float32, gen),
        "w_gate": normal(lead + (n_experts, d_model, d_ff), si, dtype, gen),
        "w_up": normal(lead + (n_experts, d_model, d_ff), si, dtype, gen),
        "w_down": normal(lead + (n_experts, d_ff, d_model), so, dtype, gen),
    }


def _route(p: dict, xt: torch.Tensor, top_k: int):
    """f32 router logits, the top-k experts of each token (largest first)
    and a softmax over their k logits: (weights (T, k) f32, experts (T, k))."""
    gate_vals, gate_idx = torch.topk(xt.float() @ p["router"], top_k, dim=-1)
    return torch.softmax(gate_vals, dim=-1), gate_idx


def apply_moe(
    p: dict, x: torch.Tensor, *, n_experts: int, top_k: int, rules: shd.Rules,
    capacity_factor: float = 1.25, fsdp: bool = False, batch: int | None = None,
) -> torch.Tensor:
    """The MoE layer, ``repro``'s ``apply_moe``.  Without an installed mesh
    or without a model axis in ``rules``: the one-card layer
    (:func:`_moe_local`).  On an installed ``DeviceMesh`` with a model
    axis: the expert-parallel program of this rank (:func:`_moe_ep`) on
    its share of the experts (:func:`moe_shard`).  ``x`` is the whole
    batch, or with ``batch`` this rank's block of a batch of ``batch``
    rows over the batch axes (the LM per rank); the output has ``x``'s
    rows, on every rank."""
    mesh = shd.get_mesh()
    if mesh is None or rules.model_axis is None:
        return _moe_local(p, x, n_experts=n_experts, top_k=top_k)
    return _moe_ep(p, x, n_experts=n_experts, top_k=top_k, rules=rules, mesh=mesh,
                   capacity_factor=capacity_factor, fsdp=fsdp, batch=batch)


def _moe_local(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int) -> torch.Tensor:
    """The MoE layer on one card: ``repro``'s ``_moe_local`` (dropless
    top-k, a softmax over the k gate values, SwiGLU experts, their
    outputs summed in f32 with those weights, cast back to x's dtype),
    computed on the routed (token, expert) rows only.  The T·k
    assignments are sorted by expert (stably); each expert with rows runs
    its three products on its contiguous slice; the weighted rows go back
    to (token, k) order and sum over k as ``repro`` sums them.  On meta
    tensors (a shape-only run) the experts take the balanced routing
    (:func:`_expert_rows`)."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    T = xt.shape[0]
    weights, gate_idx = _route(p, xt, top_k)
    flat = gate_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    ys = _expert_outputs(p, xt[order // top_k], _expert_rows(flat, n_experts))
    out = torch.empty((T * top_k, D), dtype=torch.float32, device=x.device)
    out[order] = ys.float() * weights.reshape(-1)[order, None]
    return out.reshape(T, top_k, D).sum(dim=1).reshape(B, S, D).to(x.dtype)


def _expert_outputs(p: dict, xs: torch.Tensor, counts: list[int]) -> torch.Tensor:
    """The SwiGLU experts on rows grouped by expert: expert ``e`` on the
    next ``counts[e]`` rows of ``xs``."""
    pieces, lo = [], 0
    for e, count in enumerate(counts):
        if count:
            xe = xs[lo : lo + count]
            h = silu(xe @ p["w_gate"][e]) * (xe @ p["w_up"][e])
            pieces.append(h @ p["w_down"][e])
            lo += count
    return torch.cat(pieces) if pieces else xs[:0]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class MoEPlan(NamedTuple):
    """The static shape of the expert-parallel layer on a layout:
    ``repro``'s ``spec_x`` (x fitted over (batch axes, model) on the
    global shape) and the two capacities, from the tokens a rank routes."""

    M: int  # the model axis's size
    e_loc: int  # experts a rank holds
    batch_axes: tuple[str, ...]  # the axes x's batch is blocked over
    seq_axes: tuple[str, ...]  # the axes x's sequence is blocked over
    cap_send: int  # slots a rank sends each destination
    cap_exp: int  # slots of each local expert


def moe_plan(rules: shd.Rules, shape: tuple[int, int, int], n_experts: int, top_k: int,
             capacity_factor: float = 1.25) -> MoEPlan:
    """:class:`MoEPlan` for x of global ``shape`` (B, S, D): ``repro``'s
    ``apply_moe`` lines for ``spec_x``, ``t_loc``, ``cap_send`` and
    ``cap_exp``."""
    M = rules.model_size
    e_loc = n_experts // M
    if e_loc * M != n_experts:
        raise ValueError(f"{n_experts} experts do not divide over the model axis's {M} ranks")
    spec_x = rules.fit((rules.batch, rules.model_axis, None), shape)
    B, S, _ = shape
    t_loc = (B // rules.spec_divisor(spec_x, 0)) * (S // rules.spec_divisor(spec_x, 1))
    cap_send = _round_up(int(t_loc * top_k / M * capacity_factor) + 1, 8)
    cap_exp = _round_up(int(M * cap_send / e_loc * capacity_factor) + 1, 8)
    return MoEPlan(M, e_loc, collectives.entry_axes(spec_x[0]), collectives.entry_axes(spec_x[1]), cap_send, cap_exp)


def _dispatch(dest: torch.Tensor, n_dest: int, cap: int):
    """``repro``'s sort-based slotting: the stable order of ``dest``, the
    sorted values, and each one's rank within its destination; ranks at
    or past ``cap`` are dropped."""
    order = torch.argsort(dest, stable=True)
    dest_s = dest[order]
    start = torch.searchsorted(dest_s, torch.arange(n_dest, device=dest.device, dtype=dest_s.dtype))
    rank = torch.arange(dest.shape[0], device=dest.device) - start[torch.clamp(dest_s, max=n_dest - 1)]
    return order, dest_s, rank


def _moe_ep(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int, rules: shd.Rules, mesh,
            capacity_factor: float, fsdp: bool, batch: int | None) -> torch.Tensor:
    """This rank's part of ``repro``'s expert-parallel ``shard_map`` body
    (``local``): its (B_loc, S_loc) block of x routed top-k in f32, the
    T·k assignments sorted stably by destination rank and slotted up to
    ``cap_send`` a destination (the rest dropped), the rows and their
    int32 local-expert ids sent by two ``all_to_all``s over the model
    axis, the received slots sorted stably by local expert and slotted
    up to ``cap_exp`` an expert, the experts as ``torch.bmm`` over
    (e_loc, cap_exp, D) buffers, the outputs back to their slots and home
    by a third ``all_to_all``, and each token's kept outputs summed in
    f32 with its weights (``index_add_``).  The block's output is
    gathered over the axes it was blocked over."""
    Bx, S, D = x.shape
    B = Bx if batch is None else batch
    plan = moe_plan(rules, (B, S, D), n_experts, top_k, capacity_factor)
    M, e_loc, cap_send, cap_exp = plan.M, plan.e_loc, plan.cap_send, plan.cap_exp
    model = rules.model_axis
    b_lo, b_hi = collectives.block_of(B, plan.batch_axes, mesh) if plan.batch_axes else (0, B)
    s_lo, s_hi = collectives.block_of(S, plan.seq_axes, mesh) if plan.seq_axes else (0, S)
    # this rank's tokens vary over these axes, where x and the router are
    # the same on every rank: their cotangents are summed over them
    vary = (plan.batch_axes if batch is None else ()) + plan.seq_axes
    x = collectives.enter(x, vary, mesh)
    if batch is None:
        x = x[b_lo:b_hi]
    elif Bx != b_hi - b_lo:
        raise ValueError(f"x holds {Bx} rows; this rank's block of a batch of {B} is [{b_lo}, {b_hi})")
    x = x[:, s_lo:s_hi]
    bl, sl = x.shape[:2]

    w_gate, w_up, w_down = p["w_gate"], p["w_up"], p["w_down"]
    if w_gate.shape[0] != e_loc:
        raise ValueError(f"this rank holds {e_loc} of {n_experts} experts (moe_shard), got {w_gate.shape[0]}")
    if fsdp and rules.batch_axes:
        # the experts rest on their d_ff block over the batch axes; gathered
        # for this layer.  Used on tokens that vary over those axes, the
        # gather's backward sums the ranks' cotangents onto the block (a
        # psum_scatter); on tokens every rank shares, it keeps its own rows
        if set(rules.batch_axes) <= set(plan.batch_axes):
            gather = collectives.all_gather
        else:
            def gather(w, axes, dim, mesh):
                return collectives.gather_rows(w, axes, w.shape[dim] * collectives.axis_size(mesh, axes), mesh, dim)
        w_gate = gather(w_gate, rules.batch_axes, 2, mesh)
        w_up = gather(w_up, rules.batch_axes, 2, mesh)
        w_down = gather(w_down, rules.batch_axes, 1, mesh)
    elif batch is None:
        w_gate, w_up, w_down = (collectives.enter(w, plan.batch_axes, mesh) for w in (w_gate, w_up, w_down))

    xt = x.reshape(bl * sl, D)
    T = xt.shape[0]
    weights, gate_idx = _route({"router": collectives.enter(p["router"], vary, mesh)}, xt, top_k)
    dev = x.device
    a_tok = torch.arange(T, device=dev).repeat_interleave(top_k)
    a_exp = gate_idx.reshape(-1)
    a_w = weights.reshape(-1)
    order, dest_s, rank = _dispatch(a_exp // e_loc, M, cap_send)
    tok_s, exp_s, w_s = a_tok[order], a_exp[order], a_w[order]
    slot = torch.where(rank < cap_send, rank, cap_send)  # cap_send: the drop slot

    send_x = torch.zeros((M, cap_send + 1, D), dtype=x.dtype, device=dev)
    send_x[dest_s, slot] = xt[tok_s]
    send_le = torch.full((M, cap_send + 1), e_loc, dtype=torch.int32, device=dev)
    send_le[dest_s, slot] = (exp_s % e_loc).to(torch.int32)
    recv_x = collectives.all_to_all(send_x[:, :cap_send].contiguous(), model, mesh)
    recv_le = collectives.all_to_all(send_le[:, :cap_send].contiguous(), model, mesh)

    # second stage: the received slots grouped by local expert
    rx = recv_x.reshape(M * cap_send, D)
    order2, rle_s, rank2 = _dispatch(recv_le.reshape(M * cap_send).long(), e_loc, cap_exp)
    e_row = torch.clamp(rle_s, max=e_loc - 1)
    valid2 = (rle_s < e_loc) & (rank2 < cap_exp)
    slot2 = torch.where(valid2, rank2, cap_exp)
    buf = torch.zeros((e_loc, cap_exp + 1, D), dtype=x.dtype, device=dev)
    buf[e_row, slot2] = rx[order2]
    buf = buf[:, :cap_exp]

    y = torch.bmm(silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up), w_down)  # (e_loc, cap_exp, D)
    del buf
    y_sorted = y[e_row, torch.clamp(rank2, max=cap_exp - 1)]
    y_sorted = torch.where(valid2[:, None], y_sorted, torch.zeros((), dtype=y.dtype, device=dev))
    y_recv = torch.empty_like(y_sorted)
    y_recv[order2] = y_sorted  # repro's y_sorted[argsort(order2)]
    y_back = collectives.all_to_all(y_recv.reshape(M, cap_send, D), model, mesh)

    kept = rank < cap_send
    y_slots = y_back[dest_s, torch.clamp(rank, max=cap_send - 1)]
    y_slots = torch.where(kept[:, None], y_slots, torch.zeros((), dtype=y_slots.dtype, device=dev))
    out = torch.zeros((T, D), dtype=torch.float32, device=dev)
    out.index_add_(0, tok_s, y_slots.float() * w_s[:, None])
    out = out.reshape(bl, sl, D).to(x.dtype)
    if plan.seq_axes:
        out = collectives.gather_rows(out, plan.seq_axes, S, mesh, dim=1)
    if batch is None and plan.batch_axes:
        out = collectives.gather_rows(out, plan.batch_axes, B, mesh)
    return out


def moe_shard(p: dict, rules: shd.Rules, fsdp: bool = False) -> dict:
    """This rank's share of a MoE layer's weights (``router``, ``w_gate``,
    ``w_up``, ``w_down``; expert leaves (..., E, D, F) / (..., E, F, D),
    any leading dims) on the installed mesh: experts ``[m·e_loc,
    (m+1)·e_loc)`` for model coordinate ``m`` and, with ``fsdp`` and batch
    axes, the d_ff block of the rank's coordinate over them (``repro``'s
    ``shard_map`` in_specs); copies, the router whole.  ``p`` itself
    without a mesh or a model axis, and a leaf whose share is all of it
    (one rank) as it is."""
    mesh = shd.get_mesh()
    if mesh is None or rules.model_axis is None:
        return p
    E = p["w_gate"].shape[-3]
    e_loc = E // rules.model_size
    e_lo = collectives.axis_index(mesh, rules.model_axis) * e_loc
    cut_ff = fsdp and bool(rules.batch_axes)

    def cut(w: torch.Tensor, ff_dim: int) -> torch.Tensor:
        mine = w.narrow(w.dim() - 3, e_lo, e_loc)
        if cut_ff:
            f_lo, f_hi = collectives.block_of(w.shape[ff_dim], rules.batch_axes, mesh, even=True)
            mine = mine.narrow(ff_dim, f_lo, f_hi - f_lo)
        return w if mine.shape == w.shape else mine.clone()

    return {"router": p["router"], "w_gate": cut(p["w_gate"], -1), "w_up": cut(p["w_up"], -1),
            "w_down": cut(p["w_down"], -2)}


def moe_capacity_plain(
    p: dict, x: torch.Tensor, *, n_experts: int, top_k: int, rules: shd.Rules,
    capacity_factor: float = 1.25, model_index: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel layer's output on one card, for the tests and
    the card check: from the routing of ``x`` (B, S, D) on the layout of
    ``rules`` (its axis sizes; no mesh needed), which (token, k)
    assignments survive both capacity stages of :func:`_moe_ep`, in
    ``repro``'s slot order, and the kept ones' expert outputs summed in
    f32 with their weights (``p``: the whole experts).  Each rank's block
    is routed apart, as the rank routes it: a token's router logits are
    then the same bits on both sides, so a near tie between its k-th and
    (k+1)-th expert cannot fall otherwise.  Where the sequence is not
    blocked over the model axis (a decode step) every model rank routes
    the same tokens, and the destinations keep the copies of lower source
    ranks first; ``model_index`` picks the rank whose copies the output
    holds.  Returns (output in x's dtype, kept (B, S, k) bool)."""
    B, S, D = x.shape
    plan = moe_plan(rules, (B, S, D), n_experts, top_k, capacity_factor)
    M, e_loc, cap_send, cap_exp = plan.M, plan.e_loc, plan.cap_send, plan.cap_exp
    nb = math.prod(rules.axis_sizes[a] for a in plan.batch_axes)  # batch blocks
    seq_split = bool(plan.seq_axes)
    bb, sb = B // nb, (S // M if seq_split else S)
    weights = torch.empty((B, S, top_k), dtype=torch.float32, device=x.device)
    gate_idx = torch.empty((B, S, top_k), dtype=torch.long, device=x.device)
    for bi in range(nb):
        for s0 in range(0, S, sb):
            w, g = _route(p, x[bi * bb : (bi + 1) * bb, s0 : s0 + sb].reshape(-1, D), top_k)
            weights[bi * bb : (bi + 1) * bb, s0 : s0 + sb] = w.reshape(bb, sb, top_k)
            gate_idx[bi * bb : (bi + 1) * bb, s0 : s0 + sb] = g.reshape(bb, sb, top_k)
    xt = x.reshape(-1, D)
    kept = torch.zeros((B, S, top_k), dtype=torch.bool, device=x.device)
    for bi in range(nb):
        # each model rank's assignments, slotted by destination
        srcs = []
        for m in range(M):
            s0 = m * sb if seq_split else 0
            g = gate_idx[bi * bb : (bi + 1) * bb, s0 : s0 + sb].reshape(-1)
            order, dest_s, rank = _dispatch(g // e_loc, M, cap_send)
            srcs.append((s0, order, dest_s, rank, g))
        keep = [torch.zeros(bb * sb * top_k, dtype=torch.bool, device=x.device) for _ in range(M)]
        for j in range(M):
            # destination j's received slots, source-major: (local expert, source, assignment)
            le, origin = [], []
            for m, (_, order, dest_s, rank, g) in enumerate(srcs):
                sel = (dest_s == j) & (rank < cap_send)
                slots = torch.full((cap_send,), e_loc, dtype=torch.long, device=x.device)
                who = torch.full((cap_send,), -1, dtype=torch.long, device=x.device)
                slots[rank[sel]] = g[order[sel]] % e_loc
                who[rank[sel]] = order[sel]
                le.append(slots)
                origin.append(torch.stack([torch.full_like(who, m), who], 1))
            order2, rle_s, rank2 = _dispatch(torch.cat(le), e_loc, cap_exp)
            ok = (rle_s < e_loc) & (rank2 < cap_exp)
            src = torch.cat(origin)[order2[ok]]
            for m in range(M):
                keep[m][src[src[:, 0] == m, 1]] = True
        for m in range(M):
            if seq_split or m == model_index:
                s0 = srcs[m][0]
                kept[bi * bb : (bi + 1) * bb, s0 : s0 + sb] = keep[m].reshape(bb, sb, top_k)
    flat_k = kept.reshape(-1)
    flat = gate_idx.reshape(-1)
    idx = torch.nonzero(flat_k).reshape(-1)
    order = idx[torch.argsort(flat[idx], stable=True)]
    ys = _expert_outputs(p, xt[order // top_k], _expert_rows(flat[order], n_experts))
    out = torch.zeros((xt.shape[0] * top_k, D), dtype=torch.float32, device=x.device)
    out[order] = ys.float() * weights.reshape(-1)[order, None]
    return out.reshape(-1, top_k, D).sum(dim=1).reshape(B, S, D).to(x.dtype), kept


def _expert_rows(flat: torch.Tensor, n_experts: int) -> list[int]:
    """Each expert's routed rows, read on the host.  A shape-only run
    (``flat`` on the meta device) has no routing to read and takes the
    balanced one: T·k / E rows an expert, the first T·k mod E experts one
    more."""
    if flat.is_meta:
        q, r = divmod(flat.shape[0], n_experts)
        return [q + (e < r) for e in range(n_experts)]
    return torch.bincount(flat, minlength=n_experts).tolist()


def moe_dense(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int) -> torch.Tensor:
    """``repro``'s ``_moe_local`` as it is written: every expert on every
    token ((T, E, F) and (T, E, D) temporaries), then the k selected
    outputs gathered and summed.  The plain twin of :func:`apply_moe`,
    for the tests only: at kimi-k2's widths a prefill's temporaries would
    take tens of GB."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    weights, gate_idx = _route(p, xt, top_k)
    h = torch.einsum("td,edf->tef", xt, p["w_gate"])
    u = torch.einsum("td,edf->tef", xt, p["w_up"])
    y = torch.einsum("tef,efd->ted", silu(h) * u, p["w_down"])
    sel = torch.take_along_dim(y, gate_idx[:, :, None], dim=1)  # (T, k, D)
    return (sel * weights[:, :, None]).sum(dim=1).reshape(B, S, D).to(x.dtype)
