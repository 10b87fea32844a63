"""The port's flash decode (B7's plain version on the CPU) against
``repro``'s: ``decode_attention`` with ``repro``'s Pallas kernel in
interpret mode, and the plain softmax oracles, at ``repro``'s tolerances
(``tests/test_kernels.py``: 2e-5 in f32, 2e-2 in bf16).  Both run the
same online softmax over the same ``block_kv`` blocks; what remains is
the order of f32 sums."""

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
    q, k = torch.zeros((1, 4, 8), device="meta"), torch.zeros((1, 128, 2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        decode_attn.flash_decode_gqa(q, k, k, torch.zeros((), dtype=torch.int32), block_kv=128)
