"""Decoder-only transformer LMs (dense and MoE) with GQA and optional
qk-norm: qwen3-14b and -32b, internlm2-1.8b, granite-moe, kimi-k2.

Port of ``repro/models/transformer.py``'s serving path: ``LMConfig``,
``init_params``, ``forward`` / ``hidden_states``, ``init_cache``,
``make_prefill`` and ``make_decode_step``.  The parameters are a
dictionary of tensors with ``repro``'s tree and leaf shapes: the
per-layer leaves stacked with the layer dimension first, as ``repro``'s
``jax.vmap`` builds them.  ``repro``'s ``lax.scan`` over the layers is a
Python loop over that dimension.  The decode step writes the KV cache in
place at ``pos`` and runs its attention on kernel B7
(``layers.decode_attention``); ``repro``'s writes a new cache with
``lax.dynamic_update_slice_in_dim``, which clamps its start, so at
``pos == max_len`` it overwrites the last slot where the port raises.
A MoE config's layers hold ``moe`` (``layers.init_moe``) where a dense
one's hold ``mlp``, and run ``layers.apply_moe`` on one card.

:func:`loss_fn` is ``layers.chunked_cross_entropy`` over the hidden
states; :func:`make_train_step` accumulates the gradients of
``cfg.microbatches`` slices of the batch in f32 and takes one optimizer
step (kimi-k2's ``optimizer="adafactor"`` selects AdaFactor).  With
``cfg.remat`` each layer runs under ``torch.utils.checkpoint``, as
``repro``'s ``jax.checkpoint``: the backward recomputes a layer's
activations from its input.  Gradients reach the stacked per-layer
leaves through the slices ``_layer`` takes of them.

:func:`param_shapes` gives the parameters as meta tensors (no
allocation), :func:`param_specs` and :func:`cache_specs` their
placements under a layout's ``Rules`` (tuples, as ``repro``'s
``PartitionSpec``s), which ``launch/cells.py`` fits to the production
layouts.

Over ranks (an installed ``DeviceMesh``, one process a rank): the
tokens are the whole batch on every rank; each rank runs its block of
the batch over the batch axes (``collectives.batch_block``) and holds
what ``repro``'s placements fitted give it (:func:`held_placements`,
:func:`shard_params`): the dense layers tensor-parallel over the model
axis (``layers.TensorParallel``: q, k and v column-parallel, k and v
gathered whole, q's heads over the axis where ``act/bthd`` fits them,
``wo`` and the FFN's ``w_down`` row-parallel, each then a ``psum``),
``embed`` by vocab rows (a masked local gather, then a ``psum``: one
value and zeros, exact), ``lm_head`` by vocab columns (the loss's max by
``pmax`` and its sums by ``psum``; the logits gathered whole), the MoE
layer expert-parallel on its share of the experts, and a dimension the
axis does not divide whole (qwen3-14b's 40 heads at 16 ranks: q is
gathered and every rank attends with every head, as ``repro``'s
whole-head constraint has it, then takes its rows of ``wo``).  The
logits are gathered over the batch axes; a prefill's cache and a decode
step's cache hold the rank's block of the batch with every kv head
(``cache/kv``), and a rank's heads read their kv groups of it in place
(B7's ``kv_head_offset``).  ``make_decode_step(seq_sharded=True)`` is ``repro``'s
``long_500k`` decode on a cache whose sequence lies over the model axis
(``cache/kv_seq``): a rank holds positions ``[m·S/M, (m+1)·S/M)``
(:func:`cache_shard`), writes a new position only if it owns it, runs
B7's split kernel on its shard (``flash_decode_gqa_partials``, the
global ``kv_len`` and its offset), and the ranks' partials, gathered
over the model axis and laid out rank-major, are merged by B7's
combine kernel; its q is gathered whole, and each rank takes its rows of
the output for ``wo``.  ``repro`` gets there from a sharding constraint
and GSPMD.  Training over ranks: :func:`loss_fn` takes each rank's block's
token losses, ``psum``-ed into the global mean; the train step takes
``repro``'s microbatches, slices of the global batch, each rank its
block of each, and its rank optimizer (:func:`optimizer_for`) reduces
every gradient over the axes the batch was blocked over, but an
``fsdp`` expert slice's, which the ``all_gather``'s backward has summed;
a model-sharded leaf's gradient is the rank's block and never crosses
the model axis, and the replicated leaves (norms, the router, qk-norm)
get the same gradient on every model rank through ``collectives.enter``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.kernels.decode_attn import decode_attn as da
from repro_torch.models import layers as L
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.tree import leaves, leaves_with_paths, tree_map, value_and_grad


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_q_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    qk_norm: bool = False
    # MoE (n_experts=0 -> dense)
    n_experts: int = 0
    top_k: int = 0
    rope_theta: float = 1e6
    dtype: Any = torch.bfloat16
    # execution
    microbatches: int = 1
    q_chunk: int = 512
    kv_chunk: int = 1024
    remat: bool = True
    optimizer: str = "adamw"
    fsdp_experts: bool = False  # rest-shard expert d_ff over data axes (kimi; expert-parallel only)
    vocab_pad: int = 256  # pad embed/lm_head so the vocab dim shards evenly
    # per-arch Rules overrides (pattern -> placement), prepended to the
    # built-in table by rules_for(); a tuple of pairs so the config stays
    # hashable
    sharding_overrides: tuple[tuple[str, Any], ...] | None = None

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // self.vocab_pad) * self.vocab_pad

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        attn = self.d_model * (self.n_q_heads + 2 * self.n_kv_heads) * self.d_head
        attn += self.n_q_heads * self.d_head * self.d_model
        if self.is_moe:
            mlp = self.n_experts * 3 * self.d_model * self.d_ff + self.d_model * self.n_experts
        else:
            mlp = 3 * self.d_model * self.d_ff
        per_layer = attn + mlp + 2 * self.d_model
        return self.n_layers * per_layer + 2 * self.vocab * self.d_model

    def active_param_count(self) -> int:
        if not self.is_moe:
            return self.param_count()
        attn = self.d_model * (self.n_q_heads + 2 * self.n_kv_heads) * self.d_head
        attn += self.n_q_heads * self.d_head * self.d_model
        mlp = self.top_k * 3 * self.d_model * self.d_ff + self.d_model * self.n_experts
        per_layer = attn + mlp + 2 * self.d_model
        return self.n_layers * per_layer + 2 * self.vocab * self.d_model


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_params(cfg: LMConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from one ``torch.Generator`` seeded with
    ``seed`` on ``device`` (None: the GPU); ``repro``'s tree and shapes,
    other numbers (``repro`` draws from ``jax.random``)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, lead = cfg.d_model, (cfg.n_layers,)
    emb_scale = 1.0 / (d**0.5)
    ones = torch.ones(lead + (d,), dtype=torch.float32, device=device)
    layers = {
        "attn": L.init_attention(
            gen, d, cfg.n_q_heads, cfg.n_kv_heads, cfg.d_head, cfg.qk_norm, cfg.dtype, lead
        ),
        "ln1": ones,
        "ln2": ones.clone(),
    }
    if cfg.is_moe:
        layers["moe"] = L.init_moe(gen, d, cfg.d_ff, cfg.n_experts, cfg.dtype, lead)
    else:
        layers["mlp"] = L.init_mlp(gen, d, cfg.d_ff, cfg.dtype, lead)
    return {
        "embed": L.normal((cfg.padded_vocab, d), emb_scale, cfg.dtype, gen),
        "lm_head": L.normal((d, cfg.padded_vocab), emb_scale, cfg.dtype, gen),
        "final_norm": torch.ones((d,), dtype=torch.float32, device=device),
        "layers": layers,
    }


def param_shapes(cfg: LMConfig) -> dict:
    """:func:`init_params`' tree as meta tensors: ``repro``'s
    ``param_shapes`` (``jax.eval_shape`` of its init)."""
    d, lead, f32 = cfg.d_model, (cfg.n_layers,), torch.float32

    def meta(shape, dtype=cfg.dtype) -> torch.Tensor:
        return torch.empty(lead + shape, dtype=dtype, device="meta")

    hq, hkv = cfg.n_q_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    attn = {"wq": meta((d, hq)), "wk": meta((d, hkv)), "wv": meta((d, hkv)), "wo": meta((hq, d))}
    if cfg.qk_norm:
        attn["q_norm"] = meta((cfg.d_head,), f32)
        attn["k_norm"] = meta((cfg.d_head,), f32)
    layers = {"attn": attn, "ln1": meta((d,), f32), "ln2": meta((d,), f32)}
    if cfg.is_moe:
        e, ff = cfg.n_experts, cfg.d_ff
        layers["moe"] = {"router": meta((d, e), f32), "w_gate": meta((e, d, ff)),
                         "w_up": meta((e, d, ff)), "w_down": meta((e, ff, d))}
    else:
        layers["mlp"] = {"w_gate": meta((d, cfg.d_ff)), "w_up": meta((d, cfg.d_ff)),
                         "w_down": meta((cfg.d_ff, d))}
    return {
        "embed": torch.empty((cfg.padded_vocab, d), dtype=cfg.dtype, device="meta"),
        "lm_head": torch.empty((d, cfg.padded_vocab), dtype=cfg.dtype, device="meta"),
        "final_norm": torch.empty((d,), dtype=f32, device="meta"),
        "layers": layers,
    }


def param_specs(cfg: LMConfig, rules: shd.Rules) -> dict:
    """The parameters' placements under ``rules`` (unfitted), ``repro``'s
    ``param_specs`` entry for entry: the rule table decides the experts'
    first, so an override installed by :func:`rules_for` (kimi's FSDP
    rest-sharding) wins over both the built-in default and the
    ``fsdp_experts``-derived placements."""
    a = {"wq": rules.p_attn_in(), "wk": rules.p_attn_in(), "wv": rules.p_attn_in(),
         "wo": rules.p_attn_out()}
    if cfg.qk_norm:
        a["q_norm"] = a["k_norm"] = (None, None)
    layers = {"attn": a, "ln1": (None, None), "ln2": (None, None)}
    if cfg.is_moe:
        table_default = (None, rules.model_axis, None, None)
        e_gate = rules.spec("params/layers/moe/w_gate")
        e_up = rules.spec("params/layers/moe/w_up")
        e_down = rules.spec("params/layers/moe/w_down")
        if (e_gate, e_up, e_down) == (table_default,) * 3:
            if cfg.fsdp_experts and rules.batch_axes:
                e_gate = e_up = (None, rules.model_axis, None, rules.batch_axes)
                e_down = (None, rules.model_axis, rules.batch_axes, None)
            else:
                e_gate = e_up = e_down = rules.p_moe_experts()
        layers["moe"] = {"router": rules.p_router(), "w_gate": e_gate, "w_up": e_up, "w_down": e_down}
    else:
        layers["mlp"] = {"w_gate": rules.p_mlp_in(), "w_up": rules.p_mlp_in(),
                         "w_down": rules.p_mlp_out()}
    return {"embed": rules.p_embed(), "lm_head": rules.p_lm_head(), "final_norm": (None,),
            "layers": layers}


def rules_for(cfg: LMConfig, mesh=None) -> shd.Rules:
    """Sharding rules for one arch: the layout's table with the config's
    overrides prepended."""
    overrides = dict(cfg.sharding_overrides) if cfg.sharding_overrides else None
    return shd.Rules.from_mesh(mesh, overrides=overrides)


def shard_params(cfg: LMConfig, rules: shd.Rules, params: dict) -> dict:
    """This rank's parameters on the installed mesh: each leaf's block
    under :func:`held_placements` (``collectives.leaf_block``), a copy
    where it is cut, the leaf itself where it is whole.  ``params``
    off-mesh."""
    if shd.get_mesh() is None:
        return params

    def block(place, t: torch.Tensor) -> torch.Tensor:
        mine = collectives.leaf_block(t, place)
        return t if mine.shape == t.shape else mine.clone()

    return opt_lib.map_specs(block, held_placements(cfg, rules), params)


def tensor_parallel(cfg: LMConfig, rules: shd.Rules, whole_heads: bool = False) -> L.TensorParallel:
    """This rank's blocks of the dense layers on the installed mesh
    (``layers.tensor_parallel``; every block whole off-mesh).  A MoE
    config has no dense FFN to cut."""
    return L.tensor_parallel(rules, cfg.d_model, cfg.n_q_heads, cfg.n_kv_heads, cfg.d_head,
                             0 if cfg.is_moe else cfg.d_ff, cfg.padded_vocab, whole_heads)


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked per-layer leaves."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _block(cfg: LMConfig, rules: shd.Rules, x, lp: dict, positions, attend, batch: int | None = None,
           tp: L.TensorParallel | None = None):
    """One layer: attention (``attend(q, k, v)`` -> (B, S, heads, Dh), q
    the rank's heads ``tp.heads``, k and v every kv head), then the MLP or
    the MoE, each added to the residual stream.  ``batch``: the global
    batch when ``x`` is this rank's block of it; ``tp``: the rank's
    tensor-parallel blocks (:func:`tensor_parallel`)."""
    B, S, _ = x.shape
    h = L.rmsnorm(x, lp["ln1"])
    q, k, v = L.apply_attention_proj(
        lp["attn"], h, cfg.n_q_heads, cfg.n_kv_heads, cfg.d_head, positions, rules, cfg.rope_theta, tp
    )
    x = x + L.attention_out(attend(q, k, v).reshape(B, S, -1), lp["attn"]["wo"], tp)
    h = L.rmsnorm(x, lp["ln2"])
    if cfg.is_moe:
        y = L.apply_moe(lp["moe"], h, n_experts=cfg.n_experts, top_k=cfg.top_k, rules=rules,
                        fsdp=cfg.fsdp_experts, batch=batch)
    else:
        y = L.apply_mlp(lp["mlp"], h, rules, tp)
    return x + y, k, v


def _embed(cfg: LMConfig, params: dict, tokens: torch.Tensor, tp: L.TensorParallel | None = None) -> torch.Tensor:
    """The tokens' rows of ``embed``.  With ``tp`` cutting the vocab, the
    rank's rows of its block (zeros for a token outside it), ``psum``-ed
    over the model axis: one value and zeros, exact."""
    table = params["embed"]
    if tp is None or tp.vocab.whole:
        return table[tokens.long()].to(cfg.dtype)
    local = tokens.long() - tp.vocab.lo
    mine = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return collectives.psum(rows, tp.axis).to(cfg.dtype)


def _causal(cfg: LMConfig, S: int, tp: L.TensorParallel | None = None):
    def attend(q, k, v):
        if tp is not None:  # the kv groups the rank's heads read
            k, v = tp.groups.cut(k, 2), tp.groups.cut(v, 2)
        return L.chunked_attention(
            q, k, v, causal=True, q_chunk=min(cfg.q_chunk, S), kv_chunk=min(cfg.kv_chunk, S)
        )

    return attend


def _rows(rules: shd.Rules, B: int):
    """(lo, hi, axes, batch): this rank's block of a batch of ``B`` on the
    installed mesh, and the global batch to pass the layers (``None``
    off-mesh: the block is the batch)."""
    lo, hi, axes = collectives.batch_block(rules, B)
    return lo, hi, axes, (None if shd.get_mesh() is None else B)


def _gather(x: torch.Tensor, axes, B: int) -> torch.Tensor:
    """A rank's block of rows gathered over the batch axes (``x`` itself
    when the batch is not blocked)."""
    return collectives.gather_rows(x, axes, B, shd.get_mesh()) if axes else x


def forward(cfg: LMConfig, rules: shd.Rules, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, padded_vocab)."""
    return L.lm_logits(hidden_states(cfg, rules, params, tokens), params["lm_head"], tensor_parallel(cfg, rules))


def hidden_states(cfg: LMConfig, rules: shd.Rules, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Final-norm hidden states (B, S, D): forward() without the lm_head.
    Under autograd with ``cfg.remat``, each layer is checkpointed.  On a
    mesh, this rank's block of the batch, gathered over the batch axes."""
    x, (lo, hi, axes) = _hidden_block(cfg, rules, params, tokens)
    return _gather(x, axes, tokens.shape[0])


def _hidden_block(cfg: LMConfig, rules: shd.Rules, params: dict, tokens: torch.Tensor):
    """This rank's block of the final-norm hidden states, and (lo, hi,
    axes), the block's rows and the axes they are blocked over."""
    B, S = tokens.shape
    lo, hi, axes, batch = _rows(rules, B)
    tp = tensor_parallel(cfg, rules)
    x = _embed(cfg, params, tokens[lo:hi], tp)
    positions = torch.arange(S, device=x.device)[None].expand(hi - lo, S)
    remat = cfg.remat and torch.is_grad_enabled()
    mesh = shd.get_mesh()
    for i in range(cfg.n_layers):

        def layer(x, i=i):
            # a CUDA backward recomputes the layer on autograd's device
            # thread, where the installed mesh (a context variable) is unset
            with shd.use_mesh(mesh):
                return _block(cfg, rules, x, _layer(params["layers"], i), positions, _causal(cfg, S, tp), batch,
                              tp)[0]

        x = checkpoint(layer, x, use_reentrant=False) if remat else layer(x)
    return L.rmsnorm(x, params["final_norm"]), (lo, hi, axes)


def loss_fn(cfg: LMConfig, rules: shd.Rules, params: dict, tokens: torch.Tensor, labels: torch.Tensor):
    """Token-mean next-token cross entropy, the vocab's padding masked.
    On a mesh whose batch axes block the batch, each rank's block's mean
    times its tokens, ``psum``-ed over those axes, over the batch's
    tokens: the global mean on every rank."""
    x, (lo, hi, axes) = _hidden_block(cfg, rules, params, tokens)
    ce = L.chunked_cross_entropy(x, params["lm_head"], labels[lo:hi], rules, n_valid=cfg.vocab,
                                 tp=tensor_parallel(cfg, rules))
    if not axes:
        return ce
    B, S = tokens.shape
    return collectives.psum(ce * ((hi - lo) * S), axes, shd.get_mesh()) / (B * S)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def held_placements(cfg: LMConfig, rules: shd.Rules) -> dict:
    """The placement each rank holds its parameters under on the installed
    mesh (:func:`shard_params`): ``repro``'s placements
    (:func:`param_specs`) fitted to each leaf's shape, so the dense
    layers' leaves lie over the model axis where it divides them and stay
    whole where it does not; a MoE config's experts over the model axis
    (with ``cfg.fsdp_experts``, d_ff over the batch axes too).  Every leaf
    whole off-mesh."""
    mesh = shd.get_mesh()
    shapes = param_shapes(cfg)
    if mesh is None:
        return tree_map(lambda t: tuple(None for _ in t.shape), shapes)
    out = opt_lib.map_specs(lambda spec, t: shd.fit_spec(mesh, spec, tuple(t.shape)),
                            param_specs(cfg, rules), shapes)
    if cfg.is_moe and rules.model_axis is not None:
        ff = _entry(rules.batch_axes) if cfg.fsdp_experts and rules.batch_axes else None
        m = rules.model_axis
        out["layers"]["moe"].update({"w_gate": (None, m, None, ff), "w_up": (None, m, None, ff),
                                     "w_down": (None, m, ff, None)})
    return out


def _entry(axes: tuple[str, ...]):
    return axes[0] if len(axes) == 1 else tuple(axes)


def optimizer_for(cfg: LMConfig, rules: shd.Rules, params: dict):
    """The train step's optimizer: ``cfg.optimizer`` on one card; on the
    installed mesh the rank's (``optimizer.on_ranks``: ZeRO-1 AdamW,
    Adafactor's means over a leaf's shards) for ``params`` as
    :func:`shard_params` cut them.  Its ``init`` makes the rank's state."""
    if shd.get_mesh() is None:
        return opt_lib.get(cfg.optimizer)
    return opt_lib.on_ranks(cfg.optimizer, params, held_placements(cfg, rules))


def _reduce_axes(cfg: LMConfig, rules: shd.Rules, params: dict, axes) -> list:
    """Each leaf's axes to sum its gradient over: the batch block's, but
    for an ``fsdp`` expert slice, which the layer's ``all_gather``
    backward has summed (a ``psum_scatter``)."""
    fsdp = cfg.is_moe and cfg.fsdp_experts and bool(rules.batch_axes) and rules.model_axis is not None
    return [() if fsdp and "['moe']" in path and "['router']" not in path else tuple(axes)
            for path, _ in leaves_with_paths(params)]


def make_train_step(cfg: LMConfig, rules: shd.Rules):
    """``train_step(params, opt_state, batch)`` -> (params, opt_state,
    mean loss): ``cfg.microbatches`` equal slices of the batch, each
    one's gradients added into f32 accumulators, their sum divided by
    the slice count, then one optimizer update (in place).  One slice
    takes the gradients in the parameters' dtype, as ``repro``'s.  On the
    installed mesh the slices are of the global batch (each rank runs its
    block of each) and the rank's optimizer (:func:`optimizer_for`;
    ZeRO-1) reduces the gradients over the axes the slice was
    blocked over."""
    optimizer = opt_lib.get(cfg.optimizer)

    def train_step(params: dict, opt_state: dict, batch: dict):
        tokens, labels = batch["tokens"], batch["labels"]
        n_micro = cfg.microbatches
        mb = tokens.shape[0] // n_micro
        if n_micro == 1:
            loss, grads = value_and_grad(lambda p: loss_fn(cfg, rules, p, tokens, labels))(params)
            losses = [loss]
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            losses = []
            for i in range(n_micro):
                t, lab = tokens[i * mb : (i + 1) * mb], labels[i * mb : (i + 1) * mb]
                loss, g = value_and_grad(lambda p: loss_fn(cfg, rules, p, t, lab))(params)
                for acc, gi in zip(leaves(grads), leaves(g)):
                    acc.add_(gi.float())
                losses.append(loss)
                del g
            for acc in leaves(grads):
                acc.div_(n_micro)
        if shd.get_mesh() is None:
            params, opt_state = optimizer.update(params, grads, opt_state)
        else:
            axes = collectives.batch_block(rules, mb)[2]
            rank_opt = optimizer_for(cfg, rules, params)
            params, opt_state = rank_opt.update(params, grads, opt_state, _reduce_axes(cfg, rules, params, axes))
        return params, opt_state, torch.stack(losses).mean()

    return train_step


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------


def init_cache(cfg: LMConfig, batch: int, max_len: int, device=None) -> dict:
    """An empty KV cache: k, v (n_layers, batch, max_len, n_kv_heads,
    d_head) in the config's dtype, zero; len a () int32 tensor, 0."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def cache_specs(cfg: LMConfig, rules: shd.Rules, seq_sharded: bool) -> dict:
    """The KV cache's placements: batch-sharded, or with ``seq_sharded``
    (long_500k) the sequence over the model axis too."""
    spec = rules.kv_cache_seq_sharded() if seq_sharded else rules.kv_cache()
    return {"k": spec, "v": spec, "len": ()}


def _seq_block(rules: shd.Rules, seq_sharded: bool) -> tuple[int, int] | None:
    """(m, M): this rank's coordinate over the model axis and its size
    when the cache's sequence lies over it; ``None`` when it does not."""
    mesh = shd.get_mesh()
    if not seq_sharded or mesh is None or rules.model_axis is None:
        return None
    return collectives.axis_index(mesh, rules.model_axis), rules.model_size


def cache_shard(cfg: LMConfig, rules: shd.Rules, cache: dict, seq_sharded: bool = False) -> dict:
    """This rank's copy of its share of a global KV cache (k, v (L, B, S,
    G, Dh)) on the installed mesh: its block of the batch over the batch
    axes (``collectives.batch_block``) and, with ``seq_sharded``, its
    positions ``[m·S/M, (m+1)·S/M)`` over the model axis (``repro``'s
    ``cache/kv_seq``; S must divide by M); ``len`` as it is.  The cache
    itself off-mesh."""
    if shd.get_mesh() is None:
        return cache
    lo, hi, _ = collectives.batch_block(rules, cache["k"].shape[1])
    m, M = _seq_block(rules, seq_sharded) or (0, 1)
    S = cache["k"].shape[2]
    if S % M:
        raise ValueError(f"a cache of {S} positions does not divide over the model axis's {M} ranks")
    s_loc = S // M
    return {name: cache[name][:, lo:hi, m * s_loc : (m + 1) * s_loc].clone() for name in ("k", "v")} | {
        "len": cache["len"]}


def make_prefill(cfg: LMConfig, rules: shd.Rules):
    """tokens (B, S) -> (last-token logits (B, padded_vocab), KV cache
    exactly S long with len S).  A caller that decodes after it copies
    the cache into an ``init_cache(max_len)`` buffer.  On a mesh the
    cache holds this rank's block of the batch, every kv head, and the
    logits are whole."""

    def prefill(params: dict, tokens: torch.Tensor):
        B, S = tokens.shape
        lo, hi, axes, batch = _rows(rules, B)
        tp = tensor_parallel(cfg, rules)
        x = _embed(cfg, params, tokens[lo:hi], tp)
        positions = torch.arange(S, device=x.device)[None].expand(hi - lo, S)
        ks, vs = [], []
        for i in range(cfg.n_layers):
            x, k, v = _block(cfg, rules, x, _layer(params["layers"], i), positions, _causal(cfg, S, tp), batch, tp)
            ks.append(k)
            vs.append(v)
        x = L.rmsnorm(x[:, -1:], params["final_norm"])
        logits = _gather(L.lm_logits(x, params["lm_head"], tp), axes, B)
        cache = {
            "k": torch.stack(ks),
            "v": torch.stack(vs),
            "len": torch.tensor(S, dtype=torch.int32, device=x.device),
        }
        return logits[:, 0], cache

    return prefill


def make_decode_step(cfg: LMConfig, rules: shd.Rules, seq_sharded: bool = False):
    """One token per sequence against the KV cache (the serve step of
    decode_32k and long_500k).  ``decode_step(params, cache, tokens)``
    writes the new keys and values into ``cache["k"]`` and ``cache["v"]``
    in place at ``pos = cache["len"]``, attends over the first pos + 1
    positions on B7, and returns (logits (B, padded_vocab), a cache
    holding the same k and v tensors and len pos + 1).  It reads pos on
    the host, to index the write and to raise on a full cache; a
    shape-only run (meta K and V) passes ``len`` as a CPU tensor.

    On a mesh the cache is this rank's share (:func:`cache_shard`): its
    block of the batch and, with ``seq_sharded`` and a model axis, its
    positions ``[m·S_loc, (m+1)·S_loc)`` of the global S = M·S_loc; the
    rank that owns ``pos`` writes it, every rank runs B7's split kernel
    on its shard against the global ``kv_len``, and the partials,
    gathered over the model axis (one ``all_gather`` a layer), are merged
    by B7's combine kernel.  Off a mesh ``seq_sharded`` changes nothing,
    as ``repro``'s constraint is the identity there.  Under tensor
    parallelism every model rank writes the same new keys and values into
    its copy of the cache; a rank's heads read their kv groups of it
    (``layers.decode_attention``'s ``groups``); the logits are whole.
    The seq-sharded decode attends with every head on each rank's
    positions and cuts the output to the rank's ``wo`` rows."""

    def decode_step(params: dict, cache: dict, tokens: torch.Tensor):
        B = tokens.shape[0]
        lo, hi, axes, batch = _rows(rules, B)
        sharded = _seq_block(rules, seq_sharded)
        m, M = sharded or (0, 1)
        s_loc = cache["k"].shape[2]
        max_len = s_loc * M
        pos = int(cache["len"])
        if pos >= max_len:
            raise IndexError(
                f"the KV cache is full: len {pos} of max_len {max_len} (repro's "
                f"dynamic_update_slice would clamp and overwrite position {max_len - 1})"
            )
        if cache["k"].shape[1] != hi - lo:
            raise ValueError(f"the cache holds {cache['k'].shape[1]} rows; this rank's block is [{lo}, {hi})")
        tp = tensor_parallel(cfg, rules, whole_heads=sharded is not None)
        x = _embed(cfg, params, tokens[lo:hi], tp).reshape(hi - lo, 1, cfg.d_model)
        positions = torch.full((hi - lo, 1), pos, dtype=torch.int32, device=x.device)
        kv_len = cache["len"] + 1
        mine = m * s_loc <= pos < (m + 1) * s_loc

        for i in range(cfg.n_layers):
            k_cache, v_cache = cache["k"][i], cache["v"][i]

            def attend(q, k, v, k_cache=k_cache, v_cache=v_cache):
                if mine:
                    k_cache[:, pos - m * s_loc] = k[:, 0]
                    v_cache[:, pos - m * s_loc] = v[:, 0]
                if sharded is None:
                    return L.decode_attention(q, k_cache, v_cache, kv_len, tp.groups)
                return _seq_sharded_attention(rules, q, k_cache, v_cache, kv_len, m * s_loc)

            x, _, _ = _block(cfg, rules, x, _layer(params["layers"], i), positions, attend, batch, tp)
        x = L.rmsnorm(x, params["final_norm"])
        logits = _gather(L.lm_logits(x, params["lm_head"], tp)[:, 0], axes, B)
        return logits, {"k": cache["k"], "v": cache["v"], "len": kv_len}

    return decode_step


def _seq_sharded_attention(rules: shd.Rules, q, k_cache, v_cache, kv_len, kv_offset: int):
    """Decode attention on this rank's cache shard: B7's partials of its
    positions, gathered over the model axis, laid out rank-major as one
    split axis, merged by B7's combine kernel.  q (B, 1, H, Dh) ->
    (B, 1, H, Dh)."""
    B, _, H, Dh = q.shape
    part = da.flash_decode_gqa_partials(q.reshape(B, H, Dh), k_cache, v_cache, kv_len, kv_offset,
                                        block_kv=math.gcd(k_cache.shape[1], 512))
    gathered = collectives.all_gather(part.buf[None], rules.model_axis, 0, shd.get_mesh())  # (M, numel)
    return da.flash_decode_combine(da.ranks_major(gathered, part.shape), q.dtype).reshape(B, 1, H, Dh)
