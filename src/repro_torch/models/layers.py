"""Transformer building blocks: RMSNorm, RoPE, GQA attention (qk-norm
optional), chunked flash-style attention, decode attention on kernel B7,
the SwiGLU FFN and the MoE layer.

Port of ``repro/models/layers.py`` without ``apply_moe``'s
expert-parallel branch (``shard_map``, two ``all_to_all``s,
capacities), which waits for the multi-GPU item (ROADMAP A14).  The
losses (:func:`cross_entropy`, :func:`chunked_cross_entropy`) train the
LMs; every layer is differentiable by autograd.  Everything is functional: ``init_*``
build dictionaries of tensors, ``apply_*`` consume them.  ``rules`` is
taken where ``repro`` takes it; off-mesh its constraints are the
identity, and the port runs on one card, so none is applied.

Promotions follow ``repro``'s: norms and RoPE compute in f32 and cast
back to the input's dtype; products of bf16 tensors are bf16.
:func:`decode_attention` runs B7 (``kernels/decode_attn/ops.py``), where
``repro``'s layer is a plain softmax: the same function, an online
softmax that rounds p to V's dtype relative to another running max, so
they agree to B7's tolerances (2e-5 in f32, 2e-2 in bf16).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

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
    x: torch.Tensor, lm_head: torch.Tensor, labels: torch.Tensor, rules: shd.Rules, n_valid: int
) -> torch.Tensor:
    """Token-mean cross entropy computed in vocab chunks, ``repro``'s
    layout: the head viewed as (D, M, n2, vc2), M the model axis's shard
    count (1 on one card), the chunks splitting each shard's columns.
    Two passes over the chunks: the running max (no gradient, as
    ``repro``'s ``stop_gradient``), then the exp-sums and the gold logit,
    each chunk's body under ``torch.utils.checkpoint`` (``repro``'s
    ``jax.checkpoint``), so neither pass keeps a chunk's logits and the
    (B, S, V) logits never exist.  Running statistics are (B, S) f32."""
    B, S, D = x.shape
    V = lm_head.shape[1]
    M = max(rules.model_size, 1)
    assert V % M == 0, (V, M)
    v_shard = V // M
    n2 = _shard_chunks(v_shard)
    vc2 = v_shard // n2
    heads = lm_head.reshape(D, M, n2, vc2)
    # global column id of (m, ci, c2) is m*v_shard + ci*vc2 + c2
    m_ids = torch.arange(M, device=x.device)[:, None] * v_shard
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
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: torch.Tensor
) -> torch.Tensor:
    """Single-position attention against the KV cache, on B7.  q: (B, 1,
    H, Dh); k, v: (B, S, G, Dh), contiguous; kv_len: the valid prefix, a
    () int32 tensor on q's device.  B7's plain version walks blocks of
    ``gcd(S, 512)`` positions (its block must divide S); the kernel picks
    its own tiles and splits."""
    B, _, H, Dh = q.shape
    out = decode_ops.decode_attention(
        q.reshape(B, H, Dh), k, v, kv_len, block_kv=math.gcd(k.shape[1], 512)
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
    rules: shd.Rules, rope_theta: float = 1e6,
):
    """QKV projection + qk-norm + rope.  Returns (q, k, v)."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, n_q, d_head)
    k = (x @ p["wk"]).reshape(B, S, n_kv, d_head)
    v = (x @ p["wv"]).reshape(B, S, n_kv, d_head)
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    return rope(q, positions, rope_theta), rope(k, positions, rope_theta), v


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


def apply_mlp(p: dict, x: torch.Tensor, rules: shd.Rules) -> torch.Tensor:
    return (silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


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


def apply_moe(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int, rules: shd.Rules) -> torch.Tensor:
    """The MoE layer on one card: ``repro``'s ``_moe_local`` (dropless
    top-k, a softmax over the k gate values, SwiGLU experts, their
    outputs summed in f32 with those weights, cast back to x's dtype),
    computed on the routed (token, expert) rows only.  The T·k
    assignments are sorted by expert (stably); each expert with rows runs
    its three products on its contiguous slice; the weighted rows go back
    to (token, k) order and sum over k as ``repro`` sums them.  ``rules``
    of a layout with a model axis would take ``repro``'s expert-parallel
    branch, which is not ported: it raises.  On meta tensors (a
    shape-only run) the experts take the balanced routing
    (:func:`_expert_rows`)."""
    if rules.model_axis is not None:
        raise NotImplementedError(
            "the expert-parallel MoE (experts over the model axis, two all_to_alls) is "
            "ROADMAP's multi-GPU item: the port runs the MoE on one card"
        )
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    T = xt.shape[0]
    weights, gate_idx = _route(p, xt, top_k)
    flat = gate_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    xs = xt[order // top_k]  # (T·k, D): each assignment's token, grouped by expert
    pieces, lo = [], 0
    for e, count in enumerate(_expert_rows(flat, n_experts)):
        if count:
            xe = xs[lo : lo + count]
            h = silu(xe @ p["w_gate"][e]) * (xe @ p["w_up"][e])
            pieces.append(h @ p["w_down"][e])
            lo += count
    ys = torch.cat(pieces)
    out = torch.empty((T * top_k, D), dtype=torch.float32, device=x.device)
    out[order] = ys.float() * weights.reshape(-1)[order, None]
    return out.reshape(T, top_k, D).sum(dim=1).reshape(B, S, D).to(x.dtype)


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
