"""Port paged KV cache vs the reference: ``BlockAllocator``, ``PagedKVCache``
and ``paged_decode_attention`` of ``repro_torch.serving.kvcache`` against
``repro.serving.kvcache``.

The reference's paged tests (tests/test_system.py) run on the port, the
same numpy pages go through both packages' paged decode (f32, the
reference test's 1e-5), and the pools, gathers and byte counts agree.  The
``gpu`` test holds the split-K decode kernel, reached through the paged
gather at smollm-135m's decode shape, to the plain version:
    python -m pytest -q -m gpu tests/test_torch_paged_kv.py

The reference package is imported inside the CPU tests only, so the ``gpu``
test also runs where JAX is not installed.
"""
import random

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref as tref
from repro_torch.serving.kvcache import (
    BlockAllocator,
    PagedKVCache,
    live_kv_bytes,
    paged_decode_attention,
)

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ for sm_90a)")
    return torch.device("cuda")


def _shuffled(n_blocks, seed):
    """An allocator that hands out its blocks in a seeded random order: each
    block taken alone, then all freed in a shuffled order."""
    alloc = BlockAllocator(n_blocks)
    for i in range(n_blocks):
        alloc.allocate(-1 - i)
    for i in random.Random(seed).sample(range(n_blocks), n_blocks):
        alloc.free(-1 - i)
    return alloc


def _scatter(seed, lengths, n_blocks, block_size, hkv, d, shuffle=False):
    """Seeded per-sequence K/V and their pages: returns the allocator, the
    (B, max_blocks) int32 tables, the pools and each sequence's K/V."""
    rng = np.random.default_rng(seed)
    alloc = _shuffled(n_blocks, seed) if shuffle else BlockAllocator(n_blocks)
    max_blocks = max(-(-n // block_size) for n in lengths)
    pool_k = np.zeros((n_blocks, block_size, hkv, d), np.float32)
    pool_v = np.zeros_like(pool_k)
    tables = np.zeros((len(lengths), max_blocks), np.int32)
    kv = []
    for b, n in enumerate(lengths):
        ks = rng.standard_normal((n, hkv, d)).astype(np.float32)
        vs = rng.standard_normal((n, hkv, d)).astype(np.float32)
        kv.append((ks, vs))
        blocks = alloc.allocate(b, -(-n // block_size))
        tables[b, :len(blocks)] = blocks
        for t in range(n):
            pool_k[blocks[t // block_size], t % block_size] = ks[t]
            pool_v[blocks[t // block_size], t % block_size] = vs[t]
    return alloc, tables, pool_k, pool_v, kv


def _contiguous(kv, smax):
    """The same K/V as (B, smax, Hkv, D) caches, zero past each length."""
    k = np.zeros((len(kv), smax) + kv[0][0].shape[1:], np.float32)
    v = np.zeros_like(k)
    for b, (ks, vs) in enumerate(kv):
        k[b, :len(ks)], v[b, :len(vs)] = ks, vs
    return k, v


# ---------------------------------------------------------------------------
# the reference's paged tests (tests/test_system.py), on the port
# ---------------------------------------------------------------------------
def test_block_allocator_roundtrip():
    a = BlockAllocator(8)
    t0 = a.allocate(0, 3)
    t1 = a.allocate(1, 2)
    assert len(set(t0) | set(t1)) == 5 and a.n_free == 3
    a.free(0)
    assert a.n_free == 6
    t2 = a.allocate(2, 6)
    assert len(set(t2) | set(t1)) == 8 and a.n_free == 0
    with pytest.raises(MemoryError):
        a.allocate(3, 1)


def test_paged_decode_matches_contiguous():
    """Paged gather + ragged mask == contiguous decode attention oracle."""
    gen = torch.Generator().manual_seed(3)
    B, H, HKV, D, BS, NB = 2, 4, 2, 16, 4, 8  # pool: 8 blocks of 4 tokens
    max_blocks = 4
    cache = PagedKVCache.create(NB, BS, HKV, D, torch.float32, device="cpu")
    alloc = BlockAllocator(NB)
    lengths = [13, 7]
    kv = {}
    for b, L in enumerate(lengths):
        alloc.allocate(b, -(-L // BS))
        ks = torch.randn((L, HKV, D), generator=gen)
        vs = torch.randn((L, HKV, D), generator=gen)
        kv[b] = (ks, vs)
        for t in range(L):
            blk = alloc.table(b)[t // BS]
            cache = cache.append(blk, t % BS, ks[t], vs[t])
    tables = np.zeros((B, max_blocks), np.int32)
    for b in range(B):
        tb = alloc.table(b)
        tables[b, : len(tb)] = tb
    q = torch.randn((B, 1, H, D), generator=gen)
    got = paged_decode_attention(q, cache, torch.from_numpy(tables),
                                 torch.tensor(lengths, dtype=torch.int32))
    # contiguous oracle, one sequence at a time
    for b, L in enumerate(lengths):
        ks, vs = kv[b]
        want = tref.decode_attention_ref(q[b:b + 1], ks[None], vs[None], L)
        torch.testing.assert_close(got[b:b + 1], want, **TOL["float32"])


# ---------------------------------------------------------------------------
# parity with the reference package
# ---------------------------------------------------------------------------
def test_block_allocator_hands_out_the_references_blocks():
    from repro.serving.kvcache import BlockAllocator as RefAllocator

    ops_ = [("allocate", 0, 3), ("allocate", 1, 2), ("free", 0), ("allocate", 2, 4),
            ("allocate", 1, 1), ("free", 2), ("allocate", 3, 5), ("free", 9)]
    port, ref = BlockAllocator(12), RefAllocator(12)
    for op in ops_:
        if op[0] == "allocate":
            assert port.allocate(op[1], op[2]) == ref.allocate(op[1], op[2])
        else:
            port.free(op[1])
            ref.free(op[1])
        assert port.n_free == ref.n_free and port.tables == ref.tables
    for a in (port, ref):
        with pytest.raises(MemoryError):
            a.allocate(4, a.n_free + 1)


@pytest.mark.parametrize("lengths,bs", [([13, 7], 4), ([1, 16, 17, 40], 16), ([64, 3], 16)])
def test_paged_decode_matches_the_references(lengths, bs):
    """The same numpy pages through both packages' paged decode (f32)."""
    import jax.numpy as jnp

    from repro.serving.kvcache import PagedKVCache as RefCache
    from repro.serving.kvcache import paged_decode_attention as ref_paged

    hq, hkv, d = 4, 2, 16
    n_blocks = sum(-(-n // bs) for n in lengths) + 2
    _, tables, pool_k, pool_v, _ = _scatter(5, lengths, n_blocks, bs, hkv, d, shuffle=True)
    q = np.random.default_rng(6).standard_normal((len(lengths), 1, hq, d)).astype(np.float32)
    want = ref_paged(jnp.asarray(q), RefCache(jnp.asarray(pool_k), jnp.asarray(pool_v), bs),
                     jnp.asarray(tables), jnp.asarray(lengths, jnp.int32))
    cache = PagedKVCache(torch.from_numpy(pool_k), torch.from_numpy(pool_v), bs)
    got = paged_decode_attention(torch.from_numpy(q), cache, torch.from_numpy(tables),
                                 torch.tensor(lengths, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_appends_and_gathers_equal_the_references(dtype):
    import jax.numpy as jnp

    from repro.serving.kvcache import PagedKVCache as RefCache
    from repro.serving.kvcache import live_kv_bytes as ref_live_kv_bytes

    nb, bs, hkv, d = 6, 4, 2, 8
    rng = np.random.default_rng(11)
    port = PagedKVCache.create(nb, bs, hkv, d, getattr(torch, dtype), device="cpu")
    ref = RefCache.create(nb, bs, hkv, d, getattr(jnp, dtype))
    k1, v1 = (rng.standard_normal((hkv, d)).astype(np.float32) for _ in range(2))
    port = port.append(3, 1, torch.from_numpy(k1), torch.from_numpy(v1))
    ref = ref.append(jnp.int32(3), jnp.int32(1), jnp.asarray(k1), jnp.asarray(v1))
    ids, offs = np.array([0, 5, 2], np.int32), np.array([3, 0, 2], np.int32)
    kb, vb = (rng.standard_normal((3, hkv, d)).astype(np.float32) for _ in range(2))
    port = port.append_batch(torch.from_numpy(ids), torch.from_numpy(offs),
                             torch.from_numpy(kb), torch.from_numpy(vb))
    ref = ref.append_batch(jnp.asarray(ids), jnp.asarray(offs), jnp.asarray(kb),
                           jnp.asarray(vb))
    for got, want in ((port.pool_k, ref.pool_k), (port.pool_v, ref.pool_v)):
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    table = np.array([3, 0, 5], np.int32)
    tables = np.array([[3, 0], [5, 2]], np.int32)
    for got, want in ((port.gather(torch.from_numpy(table)), ref.gather(jnp.asarray(table))),
                      (port.gather_batch(torch.from_numpy(tables)),
                       ref.gather_batch(jnp.asarray(tables)))):
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape and g.is_contiguous()
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
    assert live_kv_bytes(port) == ref_live_kv_bytes(ref) == 2 * nb * bs * hkv * d * (
        4 if dtype == "float32" else 2)


def test_create_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        PagedKVCache.create(4, 16, 2, 8)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_paged_decode_cuda_bf16_matches_plain(cuda):
    """smollm-135m's decode shape (8 slots, 9/3 heads, D 64) over shuffled
    16-token pages, lengths at 1, a block edge and 2048."""
    lengths = [1, 16, 17, 2048, 700, 64, 65, 128]
    bs = 16
    n_blocks = sum(-(-n // bs) for n in lengths) + 8
    _, tables, pool_k, pool_v, kv = _scatter(7, lengths, n_blocks, bs, 3, 64, shuffle=True)
    cache = PagedKVCache(torch.from_numpy(pool_k).to(cuda, torch.bfloat16),
                         torch.from_numpy(pool_v).to(cuda, torch.bfloat16), bs)
    q = torch.from_numpy(np.random.default_rng(8).standard_normal((8, 1, 9, 64))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    t = torch.from_numpy(tables).to(cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = ops.launch_counts().get("decode_attention", 0)
    got = paged_decode_attention(q, cache, t, lens)
    torch.cuda.synchronize()
    assert ops.launch_counts().get("decode_attention", 0) == before + 1
    k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16)
            for x in _contiguous(kv, tables.shape[1] * bs))
    want = tref.decode_attention_ref(q, k, v, lens)
    torch.testing.assert_close(got.float(), want.float(), **TOL["bfloat16"])
