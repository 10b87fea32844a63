"""GQA flash decoding: one new query token per sequence against a long
KV cache.

Port of ``repro/kernels/decode_attn/decode_attn.py::flash_decode_gqa``
(kernel B7).  ``repro``'s Pallas grid is (batch × kv group, kv block),
the kv-block axis sequential, with the online softmax's running max,
sum and f32 accumulator in VMEM scratch across it; one instance holds
all r = H / G q-heads of its group.  Here, on CUDA tensors,
:func:`flash_decode_gqa` launches the hand-written kernel of
``csrc/decode_attn.cu``: one CTA per (batch, kv group) that loops over
the kv positions itself, reading ``kv_len`` from device memory.  On CPU
tensors it runs :func:`flash_decode_gqa_plain`, the same online softmax
over ``block_kv`` blocks in plain PyTorch; there is no fallback from the
one to the other.

The two agree to rounding, not bit for bit: the kernel walks kv tiles of
64 positions where the plain version walks ``block_kv``, so p is
rounded to V's dtype relative to a different running max, and the sums
run in another order.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

LAUNCHES = 0  # B7: flash_decode_gqa

_DTYPES = {torch.float32: "decode_attn_f32", torch.bfloat16: "decode_attn_bf16"}
_MASKED = -1e30
MAX_GROUP_ROWS = 16  # q-heads per kv group the kernel holds
MAX_HEAD_DIM = 256


def _shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_kv: int):
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"need q (B, H, Dh) and k, v (B, S, G, Dh); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, dh = q.shape
    kb, s, g, kdh = k.shape
    if (kb, kdh) != (b, dh) or h % g:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)} in GQA")
    if s % block_kv:
        raise ValueError(f"S={s} must be a multiple of block_kv={block_kv}")
    return b, h, dh, s, g


def flash_decode_gqa_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: torch.Tensor, block_kv: int = 512
) -> torch.Tensor:
    """:func:`flash_decode_gqa` in plain PyTorch: ``repro``'s online
    softmax, block by block of ``block_kv`` positions, f32 statistics and
    accumulator, p rounded to V's dtype before P·V."""
    b, h, dh, s, g = _shapes(q, k, v, block_kv)
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    qg = q.reshape(b, g, h // g, dh).float()
    kv_len = torch.as_tensor(kv_len, device=dev)
    m = torch.full((b, g, h // g, 1), _MASKED, device=dev)
    l = torch.zeros((b, g, h // g, 1), device=dev)
    acc = torch.zeros((b, g, h // g, dh), device=dev)
    for lo in range(0, s, block_kv):
        scores = torch.einsum("bgrd,bsgd->bgrs", qg, k[:, lo : lo + block_kv].float()) * scale
        pos = torch.arange(lo, lo + block_kv, device=dev)
        scores = torch.where(pos < kv_len, scores, torch.tensor(_MASKED, device=dev))
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        p = torch.exp(scores - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bgrs,bsgd->bgrd", p.to(v.dtype).float(), v[:, lo : lo + block_kv].float())
        acc = acc * corr + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype).reshape(b, h, dh)


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
    if h // g > MAX_GROUP_ROWS or dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError(
            f"the kernel takes up to {MAX_GROUP_ROWS} q-heads per kv group and Dh a multiple "
            f"of 8 up to {MAX_HEAD_DIM}; got H/G={h // g}, Dh={dh}"
        )


def flash_decode_gqa(
    q: torch.Tensor,  # (B, H, Dh)
    k: torch.Tensor,  # (B, S, G, Dh)
    v: torch.Tensor,  # (B, S, G, Dh)
    kv_len: torch.Tensor,  # () int32 — valid prefix length
    block_kv: int = 512,
) -> torch.Tensor:
    """(B, H, Dh) attention output of one query token per sequence, in
    q's dtype.  Requires ``S % block_kv == 0``, as ``repro`` does.  On
    CPU tensors this is :func:`flash_decode_gqa_plain`; on CUDA tensors it
    launches B7 or raises."""
    global LAUNCHES
    if q.device.type == "cpu":
        return flash_decode_gqa_plain(q, k, v, kv_len, block_kv)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_gqa runs on cuda or cpu tensors, got {q.device}")
    b, h, dh, s, g = _shapes(q, k, v, block_kv)
    _check(q, k, v, kv_len, h, g, dh)
    out = torch.empty_like(q)
    fn = getattr(_build.load("decode_attn"), _DTYPES[q.dtype])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            b, s, g, h // g, dh, 1.0 / math.sqrt(dh), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{_DTYPES[q.dtype]} launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out
