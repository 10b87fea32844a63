"""The port's flash decode (B7's plain version on the CPU) against
``repro``'s: ``decode_attention`` with ``repro``'s Pallas kernel in
interpret mode, and the plain softmax oracles, at ``repro``'s tolerances
(``tests/test_kernels.py``: 2e-5 in f32, 2e-2 in bf16).  Both run the
same online softmax over the same ``block_kv`` blocks; what remains is
the order of f32 sums.

B7's kernel splits the kv positions (split-KV) and merges the splits'
partials in a fixed order.  :func:`_split_kv_plain`, a plain twin of that
arithmetic used only here, is held against ``repro``'s
``flash_decode_gqa`` at the ``kv_len`` edges of a split, with splits that
divide S and splits that do not."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.decode_attn import ops as r_ops
from repro.kernels.decode_attn import ref as r_ref

from repro_torch.kernels.decode_attn import decode_attn, ops, ref

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _run(shape, block, kv_len, dtype, seed):
    """repro's kernel and oracle, and the port's entry point and oracle,
    on the same seeded numpy inputs, all as f32 numpy."""
    b, h, g, dh, s = shape
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, g, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, g, dh)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    n = torch.tensor(kv_len, dtype=torch.int32)
    got = ops.decode_attention(tq, tk, tv, n, block_kv=block)
    assert got.dtype == tdt and got.shape == (b, h, dh)
    return {
        "repro": np.asarray(r_ops.decode_attention(jq, jk, jv, jnp.int32(kv_len), block_kv=block, interpret=True), np.float32),
        "repro_ref": np.asarray(r_ref.decode_attention_ref(jq, jk, jv, jnp.int32(kv_len)), np.float32),
        "port": got.float().numpy(),
        "port_ref": ref.decode_attention_ref(tq, tk, tv, n).float().numpy(),
    }


def _close(a, b, tol):
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "shape, block", [((2, 8, 4, 64, 512), 128), ((1, 16, 8, 128, 1024), 256), ((3, 4, 1, 64, 256), 128)]
)
def test_decode_attention_matches_repro(shape, block, dtype):
    """repro's three shapes × {f32, bf16}, kv_len = S - 17."""
    out = _run(shape, block, shape[-1] - 17, dtype, shape[0] * shape[1])
    tol = DTYPES[dtype][2]
    _close(out["port"], out["repro"], tol)
    _close(out["port"], out["port_ref"], tol)
    _close(out["port_ref"], out["repro_ref"], tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_short_prefix(dtype):
    """kv_len smaller than one block: masking must handle it."""
    out = _run((1, 4, 2, 64, 512), 128, 5, dtype, 0)
    _close(out["port"], out["repro"], DTYPES[dtype][2])
    _close(out["port"], out["port_ref"], DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_qwen3_group_of_five(dtype):
    """r = H / G = 5 (qwen3-14b: 40 q-heads over 8 kv heads) at a narrow
    head dim: not a power of two."""
    out = _run((2, 40, 8, 32, 256), 128, 200, dtype, 5)
    _close(out["port"], out["repro"], DTYPES[dtype][2])
    _close(out["port"], out["port_ref"], DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kv_len_zero_averages_v(dtype):
    """kv_len 0 masks every score to -1e30, so every position weighs the
    same and the output is V's mean over the cache, in repro as here."""
    out = _run((1, 8, 2, 64, 256), 128, 0, dtype, 3)
    _close(out["port"], out["repro"], DTYPES[dtype][2])
    _close(out["port"], out["repro_ref"], DTYPES[dtype][2])


def test_s_must_be_a_multiple_of_block_kv():
    q, k = torch.zeros((1, 4, 8)), torch.zeros((1, 100, 2, 8))
    with pytest.raises(ValueError, match="multiple of block_kv"):
        ops.decode_attention(q, k, k, torch.tensor(3, dtype=torch.int32), block_kv=64)


def test_cpu_calls_launch_no_kernel():
    before = decode_attn.LAUNCHES
    _run((1, 4, 2, 64, 256), 128, 100, "f32", 1)
    assert decode_attn.LAUNCHES == before


def test_wrapper_refuses_other_devices():
    """Meta q, k, v are a shape-only call (an empty meta output, no
    launch); k and v on another device than q are refused."""
    q, k = torch.zeros((1, 4, 8), device="meta"), torch.zeros((1, 128, 2, 8), device="meta")
    before = decode_attn.LAUNCHES
    out = decode_attn.flash_decode_gqa(q, k, k, torch.zeros((), dtype=torch.int32), block_kv=128)
    assert (out.shape, out.dtype, out.device.type) == ((1, 4, 8), q.dtype, "meta")
    assert decode_attn.LAUNCHES == before
    with pytest.raises(ValueError, match="q on meta"):
        decode_attn.flash_decode_gqa(q, torch.zeros(k.shape), k, torch.zeros((), dtype=torch.int32),
                                     block_kv=128)


# ---------------------------------------------------------------------------
# B7's split-KV arithmetic
# ---------------------------------------------------------------------------


def _split_kv_plain(q, k, v, kv_len: int, split_len: int, tile: int = 64) -> torch.Tensor:
    """B7's arithmetic in plain PyTorch.  Split s walks positions
    [s·L, min(S, (s+1)·L)) in tiles of ``tile`` with an online softmax
    (f32 statistics; p rounded to V's dtype before P·V; l sums the
    unrounded p).  With kv_len >= 1 it stops at kv_len, and a split that
    starts there writes m = -1e30, l = 0, acc = 0; with kv_len <= 0 every
    position scores -1e30.  Positions past the split's end are absent
    (-inf).  The partials merge in the order 0 .. n_split-1."""
    b, h, dh = q.shape
    s, g = k.shape[1], k.shape[2]
    r = h // g
    qg = q.reshape(b, g, r, dh).float()
    all_masked = kv_len <= 0
    parts = []
    for lo in range(0, s, split_len):
        hi = min(s, lo + split_len)
        end = hi if all_masked else min(kv_len, hi)
        m = torch.full((b, g, r, 1), -1e30)
        l = torch.zeros((b, g, r, 1))
        acc = torch.zeros((b, g, r, dh))
        for t0 in range(lo, end, tile):
            t1 = min(t0 + tile, s)
            x = torch.einsum("bgrd,bsgd->bgrs", qg, k[:, t0:t1].float()) / math.sqrt(dh)
            present = torch.arange(t0, t1) < end
            x = torch.where(present, torch.tensor(-1e30) if all_masked else x, torch.tensor(-math.inf))
            m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
            p = torch.exp(x - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.einsum("bgrs,bsgd->bgrd", p.to(v.dtype).float(), v[:, t0:t1].float())
            m = m_new
        parts.append((m, l, acc))
    m_star = torch.stack([p[0] for p in parts]).amax(dim=0)
    l = torch.zeros_like(m_star)
    acc = torch.zeros((b, g, r, dh))
    for m_s, l_s, acc_s in parts:  # the fixed order
        w = torch.exp(m_s - m_star)
        l = l + l_s * w
        acc = acc + acc_s * w
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype).reshape(b, h, dh)


SPLIT_S, SPLIT_BLOCK = 256, 64
# split lengths: 64 divides S; 96 does not (96, 96, 64), and its second
# tile of 64 is partial (32 positions)
SPLIT_LENS = (64, 96)
# kv_len at the edges of a split of length L, and of the cache
KV_LENS = {
    "-1": lambda L: -1, "0": lambda L: 0, "1": lambda L: 1, "L-1": lambda L: L - 1,
    "L": lambda L: L, "L+1": lambda L: L + 1, "S-17": lambda L: SPLIT_S - 17, "S": lambda L: SPLIT_S,
}


_REPRO: dict = {}


def _split_inputs(dtype, r, kv_len):
    """Seeded (B=2, G=2, r, Dh=64, S=256) inputs in both frameworks, and
    repro's output on them (cached per kv_len)."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(100 + r)
    q = rng.normal(size=(2, 2 * r, 64)).astype(np.float32)
    k = rng.normal(size=(2, SPLIT_S, 2, 64)).astype(np.float32)
    v = rng.normal(size=(2, SPLIT_S, 2, 64)).astype(np.float32)
    key = (dtype, r, kv_len)
    if key not in _REPRO:
        jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
        _REPRO[key] = np.asarray(r_ops.decode_attention(
            jq, jk, jv, jnp.int32(kv_len), block_kv=SPLIT_BLOCK, interpret=True), np.float32)
    return tuple(torch.from_numpy(x).to(tdt) for x in (q, k, v)), _REPRO[key]


@pytest.mark.parametrize("kv_name", KV_LENS)
@pytest.mark.parametrize("split_len", SPLIT_LENS)
@pytest.mark.parametrize("r", [1, 5, 8])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_split_kv_matches_repro(dtype, r, split_len, kv_name):
    kv_len = KV_LENS[kv_name](split_len)
    (q, k, v), want = _split_inputs(dtype, r, kv_len)
    got = _split_kv_plain(q, k, v, kv_len, split_len)
    assert got.dtype == q.dtype
    _close(got.float().numpy(), want, DTYPES[dtype][2])
    n = torch.tensor(kv_len, dtype=torch.int32)
    _close(got.float().numpy(), decode_attn.flash_decode_gqa_plain(q, k, v, n, SPLIT_BLOCK).float().numpy(),
           DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_split_past_kv_len_weighs_nothing(dtype):
    """A split that starts at or past kv_len (>= 1) contributes m = -1e30,
    l = 0, acc = 0: the merge equals the merge of the splits before it."""
    (q, k, v), want = _split_inputs(dtype, 5, 60)
    short = _split_kv_plain(q, k[:, :64], v[:, :64], 60, 64)
    _close(_split_kv_plain(q, k, v, 60, 64).float().numpy(), short.float().numpy(), 0.0)
    _close(short.float().numpy(), want, DTYPES[dtype][2])


@pytest.mark.parametrize(
    "batch, groups, seq, want",
    [(128, 8, 32_768, (1, 32_768)), (1, 8, 524_288, (33, 15_936)), (2, 4, 512, (8, 64)),
     (1, 2, 1_000, (16, 64)), (3, 1, 256, (4, 64)), (40, 8, 4_096, (1, 4_096))],
)
def test_decode_splits(batch, groups, seq, want):
    """From B, G and S alone: the fewest splits that give the grid 264
    CTAs, each a multiple of 64 positions, covering S exactly once."""
    n_split, split_len = decode_attn.decode_splits(batch, groups, seq)
    assert (n_split, split_len) == want
    assert split_len % decode_attn.SPLIT_ALIGN == 0
    assert (n_split - 1) * split_len < seq <= n_split * split_len
    most = batch * groups * -(-seq // decode_attn.SPLIT_ALIGN)  # one split per 64 positions
    assert batch * groups * n_split >= min(decode_attn.SPLIT_TARGET_CTAS, most)
