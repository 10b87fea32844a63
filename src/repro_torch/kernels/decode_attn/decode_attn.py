"""GQA flash decoding: one new query token per sequence against a long
KV cache.

Port of ``repro/kernels/decode_attn/decode_attn.py::flash_decode_gqa``
(kernel B7).  ``repro``'s Pallas grid is (batch × kv group, kv block),
the kv-block axis sequential, with the online softmax's running max,
sum and f32 accumulator in VMEM scratch across it; one instance holds
all r = H / G q-heads of its group.  Here, on CUDA tensors,
:func:`flash_decode_gqa` launches the hand-written kernels of
``csrc/decode_attn.cu``: split-KV, a grid of (batch × kv group,
``n_split``) CTAs that each walk ``split_len`` positions through an
async ring of K/V tiles, with bf16 products on tensor cores, and a
combine kernel that merges the splits' f32 partials in a fixed order.
:func:`decode_splits` picks the split from B, G and S alone; ``kv_len``
stays on the device.  On CPU tensors it runs
:func:`flash_decode_gqa_plain`, the same online softmax over
``block_kv`` blocks in plain PyTorch; there is no fallback from the one
to the other.

Its three entries call custom operators defined with ``torch.library``
(``Library.define`` and ``impl``, as B6's: ``torch.ops.repro_torch``'s
``flash_decode_gqa``, ``flash_decode_gqa_partials``,
``flash_decode_combine``), each with the launch as its CUDA kernel and
the plain version as its CPU kernel, and a fake: on meta tensors (a
shape-only run, ``launch/``) it checks the inputs and returns an empty
meta output of the kernel's shape and dtype, launching nothing; a
``kv_len`` may then lie on the CPU.  A dispatch mode sees one call an
entry.  Their FLOPs are registered with ``torch.utils.flop_counter``
and ``launch/analysis.py`` charges their bytes, by :func:`decode_work`
(4·B·H·kv_len·Dh FLOPs, the scores and P·V; as bytes K and V up to
``kv_len``, q and the output), :func:`partials_work` and
:func:`combine_work`.

The two agree to rounding, not bit for bit: the kernel walks other kv
tiles than ``block_kv`` (16 positions per warp in bf16) and merges
splits, so p is rounded to V's dtype relative to a different running
max, and the sums run in another order.

A cache sharded along the sequence over ranks (the seq-sharded decode,
``models/transformer.py``) runs B7's two kernels apart through two more
entries: :func:`flash_decode_gqa_partials`, the split kernel on a
rank's positions ``[kv_offset, kv_offset + S)`` against the global
``kv_len``, returning every split's f32 (m, l, acc) (:class:`Partials`),
and :func:`flash_decode_combine`, the combine kernel over any number of
splits: the ranks' partials, gathered and laid out rank-major as one
split axis (:func:`ranks_major`).  A shard wholly past ``kv_len`` gives (-1e30, 0, 0), weight
0 in the merge; a global ``kv_len <= 0`` gives every position -1e30, so
the merge is V's mean over every shard, as ``flash_decode_gqa``.  The
partials cross the op boundary as the buffer and the five sizes of
their shape.  Their plain twins take the shard as one split: the plain online softmax of
:func:`flash_decode_gqa_plain`, stopped before its division, so that on
one shard at offset 0 partials then combine equal it bit for bit.  On
CUDA tensors, at one shard and offset 0 the two entries are
``flash_decode_gqa``'s own two launches where it splits.

A rank of a tensor-parallel layer holds some of the q heads and the
whole cache (``repro``'s ``cache/kv`` keeps the kv heads whole over the
model axis): ``flash_decode_gqa`` and ``flash_decode_gqa_partials`` take
``kv_head_offset`` and ``kv_heads``, and q's H heads read the cache's kv
groups ``[kv_head_offset, kv_head_offset + kv_heads)`` (``kv_heads`` 0:
every group from the offset on).  The kernel reads them in place, at the
whole cache's row stride; the plain twins slice a view; the formulas
count those groups' bytes only.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
from torch import Tensor
from torch.utils.flop_counter import flop_registry, register_flop_formula

from repro_torch.kernels import _build

LAUNCHES = 0  # B7: flash_decode_gqa
PARTIAL_LAUNCHES = 0  # B7's split kernel through flash_decode_gqa_partials
COMBINE_LAUNCHES = 0  # B7's combine kernel through flash_decode_combine

_DTYPES = {torch.float32: "decode_attn_f32", torch.bfloat16: "decode_attn_bf16"}
_MASKED = -1e30
MAX_GROUP_ROWS = 16  # q-heads per kv group the kernel holds
HEAD_DIMS = (64, 112, 128, 256)  # the kernel's instantiations (112: kimi-k2)
SPLIT_TARGET_CTAS = 264  # twice the H100's 132 SMs
SPLIT_ALIGN = 64  # positions; a multiple of both kernels' kv tiles (64 bf16, 32 f32)


def decode_splits(batch: int, n_groups: int, seq: int) -> tuple[int, int]:
    """(n_split, split_len): the kernel's split of the S positions of each
    (batch, kv group) into ``n_split`` runs of ``split_len`` (a multiple of
    :data:`SPLIT_ALIGN`; the last may be shorter), the fewest that give
    the grid :data:`SPLIT_TARGET_CTAS` CTAs.  From B, G and S alone:
    ``kv_len`` stays on the device."""
    chunks = -(-seq // SPLIT_ALIGN)
    want = max(1, min(-(-SPLIT_TARGET_CTAS // (batch * n_groups)), chunks))
    split_len = -(-chunks // want) * SPLIT_ALIGN
    return -(-seq // split_len), split_len


def _groups(k: torch.Tensor, kv_head_offset: int, kv_heads: int) -> int:
    """The kv groups q's heads read: ``kv_heads``, or with 0 every group of
    ``k`` from ``kv_head_offset`` on; the range must lie in ``k``."""
    g_all = k.shape[2]
    g = kv_heads or g_all - kv_head_offset
    if kv_head_offset < 0 or g < 1 or kv_head_offset + g > g_all:
        raise ValueError(f"kv groups [{kv_head_offset}, {kv_head_offset + g}) do not lie in the cache's {g_all}")
    return g


def _shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_kv: int, kv_head_offset: int = 0,
            kv_heads: int = 0):
    """(B, H, Dh, S, G): G the kv groups q's heads read (:func:`_groups`)."""
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"need q (B, H, Dh) and k, v (B, S, G, Dh); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, dh = q.shape
    kb, s, _, kdh = k.shape
    g = _groups(k, kv_head_offset, kv_heads)
    if (kb, kdh) != (b, dh) or h % g:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}'s {g} groups in GQA")
    if s % block_kv:
        raise ValueError(f"S={s} must be a multiple of block_kv={block_kv}")
    return b, h, dh, s, g


class Partials(NamedTuple):
    """B7's f32 partials of a cache's splits as the one flat buffer the
    combine kernel reads: ``m`` and ``l`` (B, G, n_split, r), the running
    max and sum of each q row, then ``acc`` (B, G, n_split, r, Dh), its
    unnormalised P·V; r = H / G.  ``shape`` is (B, G, n_split, r, Dh)."""

    buf: torch.Tensor
    shape: tuple[int, int, int, int, int]

    @property
    def rows(self) -> int:
        b, g, n_split, r, _ = self.shape
        return b * g * n_split * r

    @property
    def m(self) -> torch.Tensor:
        return self.buf[: self.rows].view(self.shape[:4])

    @property
    def l(self) -> torch.Tensor:
        return self.buf[self.rows : 2 * self.rows].view(self.shape[:4])

    @property
    def acc(self) -> torch.Tensor:
        return self.buf[2 * self.rows :].view(self.shape)


def ranks_major(bufs: torch.Tensor, shape: tuple[int, int, int, int, int]) -> Partials:
    """The partials of M shards as one :class:`Partials` of M·n_split
    splits, shard-major (the combine kernel's order over the whole
    cache): ``bufs`` (M, numel) holds each shard's ``Partials.buf`` in
    shard order, all of ``shape``.  One copy."""
    b, g, n_split, r, dh = shape
    n = bufs.shape[0]
    whole = Partials(torch.empty(bufs.numel(), dtype=torch.float32, device=bufs.device),
                     (b, g, n * n_split, r, dh))
    rows = whole.rows // n
    for dst, lo, hi, tail in ((whole.m, 0, rows, ()), (whole.l, rows, 2 * rows, ()),
                              (whole.acc, 2 * rows, bufs.shape[1], (dh,))):
        dst.view((b, g, n, n_split, r) + tail).copy_(bufs[:, lo:hi].view((n, b, g, n_split, r) + tail).movedim(0, 2))
    return whole


def _online_softmax(q, k, v, kv_len, block_kv: int, kv_offset: int = 0, absent_past_len: bool = False,
                    kv_head_offset: int = 0, kv_heads: int = 0):
    """``repro``'s online softmax over ``k``, ``v``'s positions, block by
    block, as (m, l) (B, G, r, 1) and acc (B, G, r, Dh), f32; position
    ``p`` is ``kv_offset + p`` of the global cache, G the groups
    ``[kv_head_offset, kv_head_offset + kv_heads)`` (a view).  Past
    ``kv_len`` a score is -1e30; with ``absent_past_len`` and ``kv_len >=
    1`` such a position is also absent (weight 0), as in the kernel, which
    changes nothing once a valid position has been seen."""
    b, h, dh, s, g = _shapes(q, k, v, block_kv, kv_head_offset, kv_heads)
    if g != k.shape[2]:
        k, v = k[:, :, kv_head_offset : kv_head_offset + g], v[:, :, kv_head_offset : kv_head_offset + g]
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    qg = q.reshape(b, g, h // g, dh).float()
    kv_len = torch.as_tensor(kv_len, device=dev)
    m = torch.full((b, g, h // g, 1), _MASKED, device=dev)
    l = torch.zeros((b, g, h // g, 1), device=dev)
    acc = torch.zeros((b, g, h // g, dh), device=dev)
    for lo in range(0, s, block_kv):
        scores = torch.einsum("bgrd,bsgd->bgrs", qg, k[:, lo : lo + block_kv].float()) * scale
        pos = torch.arange(kv_offset + lo, kv_offset + lo + block_kv, device=dev)
        scores = torch.where(pos < kv_len, scores, torch.tensor(_MASKED, device=dev))
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        p = torch.exp(scores - m_new)
        if absent_past_len:
            p = torch.where((pos < kv_len) | (kv_len <= 0), p, torch.zeros((), device=dev))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bgrs,bsgd->bgrd", p.to(v.dtype).float(), v[:, lo : lo + block_kv].float())
        acc = acc * corr + pv
        m = m_new
    return m, l, acc


def flash_decode_gqa_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: torch.Tensor, block_kv: int = 512,
    kv_head_offset: int = 0, kv_heads: int = 0,
) -> torch.Tensor:
    """:func:`flash_decode_gqa` in plain PyTorch: ``repro``'s online
    softmax, block by block of ``block_kv`` positions, f32 statistics and
    accumulator, p rounded to V's dtype before P·V."""
    b, h, dh = q.shape
    _, l, acc = _online_softmax(q, k, v, kv_len, block_kv, kv_head_offset=kv_head_offset, kv_heads=kv_heads)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype).reshape(b, h, dh)


def flash_decode_gqa_partials_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: torch.Tensor, kv_offset: int = 0,
    block_kv: int = 512, kv_head_offset: int = 0, kv_heads: int = 0,
) -> Partials:
    """:func:`flash_decode_gqa_partials` in plain PyTorch, the shard as one
    split: :func:`flash_decode_gqa_plain`'s online softmax over global
    positions ``kv_offset + [0, S)``, stopped before the division, with
    positions past a ``kv_len >= 1`` absent as in the kernel (a shard
    wholly past it gives (-1e30, 0, 0))."""
    b, h, dh, _, g = _shapes(q, k, v, block_kv, kv_head_offset, kv_heads)
    m, l, acc = _online_softmax(q, k, v, kv_len, block_kv, kv_offset, absent_past_len=True,
                                kv_head_offset=kv_head_offset, kv_heads=kv_heads)
    return Partials(torch.cat([m.reshape(-1), l.reshape(-1), acc.reshape(-1)]), (b, g, 1, h // g, dh))


def flash_decode_combine_plain(part: Partials, dtype: torch.dtype) -> torch.Tensor:
    """:func:`flash_decode_combine` in plain PyTorch: the combine kernel's
    merge, split by split in order 0 .. n_split - 1: m* the largest m,
    then l and acc summed with weights e^(m - m*), out = acc / max(l,
    1e-30) in ``dtype``, (B, G·r, Dh)."""
    b, g, n_split, r, dh = part.shape
    m_star = torch.full((b, g, r), _MASKED, device=part.m.device)
    for s in range(n_split):
        m_star = torch.maximum(m_star, part.m[:, :, s])
    l = torch.zeros((b, g, r), device=part.m.device)
    acc = torch.zeros((b, g, r, dh), device=part.m.device)
    for s in range(n_split):
        e = torch.exp(part.m[:, :, s] - m_star)
        l = l + part.l[:, :, s] * e
        acc = acc + part.acc[:, :, s] * e[..., None]
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(dtype).reshape(b, g * r, dh)


def _check(q, k, v, kv_len, h, g, dh) -> None:
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if kv_len.dtype != torch.int32 or kv_len.numel() != 1:
        raise TypeError("kv_len must be a one-element int32 tensor")
    for name, t in (("q", q), ("k", k), ("v", v), ("kv_len", kv_len)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if h // g > MAX_GROUP_ROWS or dh not in HEAD_DIMS:
        raise ValueError(
            f"the kernel takes up to {MAX_GROUP_ROWS} q-heads per kv group and Dh in "
            f"{HEAD_DIMS}; got H/G={h // g}, Dh={dh}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (cp.async)")


def _check_meta(q, k, v, kv_len, block_kv: int, kv_head_offset: int = 0, kv_heads: int = 0):
    """The fakes' checks: shapes, devices and dtypes."""
    shapes = _shapes(q, k, v, block_kv, kv_head_offset, kv_heads)
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"k is on {k.device}, v on {v.device}, q on {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if kv_len.dtype != torch.int32 or kv_len.numel() != 1 or kv_len.device.type not in ("meta", "cpu"):
        raise TypeError("kv_len must be a one-element int32 tensor on the meta device or the CPU")
    return shapes


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_decode_gqa(Tensor q, Tensor k, Tensor v, Tensor kv_len, SymInt block_kv=512, "
            "SymInt kv_head_offset=0, SymInt kv_heads=0) -> Tensor")
_LIB.define("flash_decode_gqa_partials(Tensor q, Tensor k, Tensor v, Tensor kv_len, SymInt kv_offset, "
            "SymInt block_kv, SymInt kv_head_offset=0, SymInt kv_heads=0) -> Tensor")
_LIB.define("flash_decode_combine(Tensor buf, SymInt b, SymInt g, SymInt n_split, SymInt r, SymInt dh, "
            "ScalarType dtype) -> Tensor")


def flash_decode_gqa(
    q: Tensor,  # (B, H, Dh)
    k: Tensor,  # (B, S, G, Dh)
    v: Tensor,  # (B, S, G, Dh)
    kv_len: Tensor,  # () int32 — valid prefix length
    block_kv: int = 512,
    kv_head_offset: int = 0,
    kv_heads: int = 0,
) -> Tensor:
    """(B, H, Dh) attention output of one query token per sequence, in
    q's dtype; q's heads read the kv groups ``[kv_head_offset,
    kv_head_offset + kv_heads)`` of the cache (``kv_heads`` 0: every
    group from the offset on).  Requires ``S % block_kv == 0``, as
    ``repro`` does.  On CPU tensors this is :func:`flash_decode_gqa_plain`;
    on CUDA tensors it launches B7 (its split kernel, then, with more than
    one split, its combine kernel: one launch in :data:`LAUNCHES`) or
    raises; on meta tensors it returns an empty meta output."""
    return torch.ops.repro_torch.flash_decode_gqa.default(q, k, v, kv_len, block_kv, kv_head_offset, kv_heads)


def decode_work(q: Tensor, k: Tensor, v: Tensor, kv_len: Tensor, block_kv: int = 512, kv_head_offset: int = 0,
                kv_heads: int = 0) -> tuple[float, float, int, bool]:
    """B7's work by formula, from :func:`flash_decode_gqa`'s arguments:
    (4·B·H·kv_len·Dh FLOPs, bytes of K and V up to ``kv_len`` in the
    groups q's heads read, q and the output, kv_len, whether the products
    run on the tensor cores: bf16).  Reads ``kv_len`` on the host (a sync
    for a CUDA tensor); a meta ``kv_len`` has no value."""
    if kv_len.is_meta:
        raise ValueError("counting B7's work needs kv_len's value: pass it as a CPU tensor")
    b, h, dh = q.shape
    g, n = _groups(k, kv_head_offset, kv_heads), int(kv_len)
    item = q.element_size()
    nbytes = (2 * b * n * g * dh + 2 * b * h * dh) * item
    return float(4 * b * h * n * dh), float(nbytes), n, q.dtype == torch.bfloat16


@torch.library.register_fake("repro_torch::flash_decode_gqa")
def _(q, k, v, kv_len, block_kv=512, kv_head_offset=0, kv_heads=0):
    _check_meta(q, k, v, kv_len, block_kv, kv_head_offset, kv_heads)
    return torch.empty_like(q)


@torch.library.impl(_LIB, "flash_decode_gqa", "CPU")
def _(q, k, v, kv_len, block_kv=512, kv_head_offset=0, kv_heads=0):
    return flash_decode_gqa_plain(q, k, v, kv_len, block_kv, kv_head_offset, kv_heads)


@torch.library.impl(_LIB, "flash_decode_gqa", "CUDA")
def _launch(q, k, v, kv_len, block_kv=512, kv_head_offset=0, kv_heads=0):
    """The op's CUDA kernel: the ctypes launch of B7."""
    global LAUNCHES
    b, h, dh, s, g = _shapes(q, k, v, block_kv, kv_head_offset, kv_heads)
    _check(q, k, v, kv_len, h, g, dh)
    n_split, split_len = decode_splits(b, g, s)
    out = torch.empty_like(q)
    # the splits' f32 partials: m and l per q row, then the accumulators
    part = None
    if n_split > 1:
        part = torch.empty(b * h * n_split * (dh + 2), dtype=torch.float32, device=q.device)
    fn = _lib_fn(_DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), b, s, g, h // g, dh, n_split, split_len,
            k.shape[2], kv_head_offset, 1.0 / math.sqrt(dh), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{_DTYPES[q.dtype]} launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out


# the argument types of the library's entries, by the entry's prefix
_ARGTYPES = {
    "decode_attn": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p],
    "decode_partials": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p],
    "decode_combine": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}


@functools.cache
def _lib_fn(name: str):
    """The library's entry ``name`` with its argument types set, resolved
    once a process."""
    fn = getattr(_build.load("decode_attn"), name)
    fn.argtypes = _ARGTYPES[name.rsplit("_", 1)[0]]
    fn.restype = ctypes.c_int
    return fn


def partial_splits(q: Tensor, k: Tensor, groups: int | None = None) -> int:
    """The splits of :func:`flash_decode_gqa_partials` on ``q``'s device
    for q's heads on ``groups`` kv groups (``None``: all of ``k``'s): one
    on the CPU (the plain twin takes the shard as one split), else the
    card's (:func:`decode_splits`, which a meta run counts).  Both are 1
    where the shard holds at most :data:`SPLIT_ALIGN` positions."""
    if q.device.type == "cpu":
        return 1
    return decode_splits(q.shape[0], k.shape[2] if groups is None else groups, k.shape[1])[0]


def flash_decode_gqa_partials(
    q: torch.Tensor,  # (B, H, Dh)
    k: torch.Tensor,  # (B, S, G, Dh): global positions [kv_offset, kv_offset + S)
    v: torch.Tensor,
    kv_len: torch.Tensor,  # () int32 — the global valid prefix
    kv_offset: int = 0,
    block_kv: int = 512,
    kv_head_offset: int = 0,
    kv_heads: int = 0,
) -> Partials:
    """B7's split kernel alone on a shard of the cache: every split's f32
    partials (:class:`Partials`), the split :func:`decode_splits` picks
    from B, G and this shard's S (G the groups q's heads read:
    ``kv_head_offset``, ``kv_heads`` as :func:`flash_decode_gqa`'s).  A
    position of the shard counts as
    global position ``kv_offset + p`` against the global ``kv_len``.  On
    CPU tensors this is :func:`flash_decode_gqa_partials_plain` (one
    split); on CUDA tensors it launches the kernel (one launch in
    :data:`PARTIAL_LAUNCHES`) or raises.  The operator
    ``repro_torch::flash_decode_gqa_partials`` returns the buffer; the
    split count is read back from its length."""
    buf = torch.ops.repro_torch.flash_decode_gqa_partials.default(q, k, v, kv_len, kv_offset, block_kv,
                                                                  kv_head_offset, kv_heads)
    b, h, dh = q.shape
    g = _groups(k, kv_head_offset, kv_heads)
    return Partials(buf, (b, g, buf.shape[0] // (b * h * (dh + 2)), h // g, dh))


def partials_work(q: Tensor, k: Tensor, v: Tensor, kv_len: Tensor, kv_offset: int, block_kv: int,
                  kv_head_offset: int = 0, kv_heads: int = 0) -> tuple[float, float, int, bool]:
    """The split kernel's work by formula: (4·B·H·n·Dh FLOPs over the n
    positions of the shard below ``kv_len``, bytes of K and V at those
    positions in the groups q's heads read, q and the f32 partials
    written, n, bf16)."""
    if kv_len.is_meta:
        raise ValueError("counting B7's work needs kv_len's value: pass it as a CPU tensor")
    b, h, dh = q.shape
    s, g = k.shape[1], _groups(k, kv_head_offset, kv_heads)
    n = min(max(int(kv_len) - kv_offset, 0), s)
    nbytes = (2 * b * n * g * dh + b * h * dh) * q.element_size() + b * h * partial_splits(q, k, g) * (dh + 2) * 4
    return float(4 * b * h * n * dh), float(nbytes), n, q.dtype == torch.bfloat16


@torch.library.register_fake("repro_torch::flash_decode_gqa_partials")
def _(q, k, v, kv_len, kv_offset, block_kv, kv_head_offset=0, kv_heads=0):
    b, h, dh, _, g = _check_meta(q, k, v, kv_len, block_kv, kv_head_offset, kv_heads)
    if kv_offset < 0:
        raise ValueError(f"kv_offset must be >= 0, got {kv_offset}")
    return q.new_empty((b * h * partial_splits(q, k, g) * (dh + 2),), dtype=torch.float32)


@torch.library.impl(_LIB, "flash_decode_gqa_partials", "CPU")
def _(q, k, v, kv_len, kv_offset, block_kv, kv_head_offset=0, kv_heads=0):
    return flash_decode_gqa_partials_plain(q, k, v, kv_len, kv_offset, block_kv, kv_head_offset, kv_heads).buf


@torch.library.impl(_LIB, "flash_decode_gqa_partials", "CUDA")
def _launch_partials(q, k, v, kv_len, kv_offset, block_kv, kv_head_offset=0, kv_heads=0):
    """The op's CUDA kernel: the ctypes launch of B7's split kernel."""
    global PARTIAL_LAUNCHES
    b, h, dh, s, g = _shapes(q, k, v, block_kv, kv_head_offset, kv_heads)
    _check(q, k, v, kv_len, h, g, dh)
    if kv_offset < 0:
        raise ValueError(f"kv_offset must be >= 0, got {kv_offset}")
    n_split, split_len = decode_splits(b, g, s)
    r = h // g
    part = torch.empty(b * g * n_split * r * (dh + 2), dtype=torch.float32, device=q.device)
    fn = _lib_fn(_DTYPES[q.dtype].replace("attn", "partials"))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), part.data_ptr(), b, s, g, r,
                 dh, n_split, split_len, kv_offset, k.shape[2], kv_head_offset, 1.0 / math.sqrt(dh),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode partials launch failed with CUDA error {err}")
    PARTIAL_LAUNCHES += 1
    return part


def flash_decode_combine(part: Partials, dtype: torch.dtype) -> torch.Tensor:
    """B7's combine kernel alone: the n_split partials of each (batch, kv
    group) merged, in split order, into the (B, G·r, Dh) output in
    ``dtype`` (float32 or bfloat16).  On CPU tensors this is
    :func:`flash_decode_combine_plain`; on CUDA tensors it launches the
    kernel on the partials' buffer (one launch in
    :data:`COMBINE_LAUNCHES`), or raises.  The operator
    ``repro_torch::flash_decode_combine`` takes the buffer and the
    partials' shape."""
    return torch.ops.repro_torch.flash_decode_combine.default(part.buf, *part.shape, dtype)


def combine_work(buf: Tensor, b: int, g: int, n_split: int, r: int, dh: int, dtype: torch.dtype
                 ) -> tuple[float, float, int, bool]:
    """The combine kernel's work by formula: (2·(Dh + 1) FLOPs a row and
    split, l's and acc's weighted sums, bytes of the partials read and
    the output written, n_split, False: f32 on the CUDA cores)."""
    rows = b * g * r
    out_bytes = rows * dh * torch.empty((), dtype=dtype, device="meta").element_size()
    return float(rows * n_split * 2 * (dh + 1)), float(buf.numel() * 4 + out_bytes), n_split, False


def _check_partials(buf, shape, dtype) -> None:
    b, g, n_split, r, dh = shape
    if dtype not in _DTYPES:
        raise TypeError(f"the output must be float32 or bfloat16, got {dtype}")
    rows = b * g * n_split * r
    if buf.dtype != torch.float32 or not buf.is_contiguous() or buf.numel() != rows * (dh + 2):
        raise ValueError(f"partials of shape {shape} need a contiguous f32 buffer of {rows * (dh + 2)} "
                         f"values, got {buf.dtype} {tuple(buf.shape)}")


@torch.library.register_fake("repro_torch::flash_decode_combine")
def _(buf, b, g, n_split, r, dh, dtype):
    _check_partials(buf, (b, g, n_split, r, dh), dtype)
    return buf.new_empty((b, g * r, dh), dtype=dtype)


@torch.library.impl(_LIB, "flash_decode_combine", "CPU")
def _(buf, b, g, n_split, r, dh, dtype):
    return flash_decode_combine_plain(Partials(buf, (b, g, n_split, r, dh)), dtype)


@torch.library.impl(_LIB, "flash_decode_combine", "CUDA")
def _launch_combine(buf, b, g, n_split, r, dh, dtype):
    """The op's CUDA kernel: the ctypes launch of B7's combine kernel."""
    global COMBINE_LAUNCHES
    _check_partials(buf, (b, g, n_split, r, dh), dtype)
    if r > MAX_GROUP_ROWS or dh not in HEAD_DIMS:
        raise ValueError(f"the kernel takes up to {MAX_GROUP_ROWS} q-heads per kv group and Dh in {HEAD_DIMS}")
    out = torch.empty((b, g * r, dh), dtype=dtype, device=buf.device)
    fn = _lib_fn(_DTYPES[dtype].replace("attn", "combine"))
    with torch.cuda.device(buf.device):
        err = fn(buf.data_ptr(), out.data_ptr(), b, g, r, dh, n_split, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode combine launch failed with CUDA error {err}")
    COMBINE_LAUNCHES += 1
    return out


# FLOPs of the three entries for torch.utils.flop_counter, by their formulas
for _op, _work in ((torch.ops.repro_torch.flash_decode_gqa, decode_work),
                   (torch.ops.repro_torch.flash_decode_gqa_partials, partials_work),
                   (torch.ops.repro_torch.flash_decode_combine, combine_work)):
    if _op not in flop_registry:
        register_flop_formula(_op, get_raw=True)(
            lambda *args, out_val=None, _work=_work, **kwargs: _work(*args, **kwargs)[0])
