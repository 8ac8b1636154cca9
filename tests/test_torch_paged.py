"""The port's paged KV cache against the JAX package on the CPU: pool and
table primitives (`init_paged_kv_cache`, `paged_write`, `paged_insert_dense`,
`paged_gather_dense`, `paged_write_multi`) bit-identical to JAX's, and
`paged_attention_decode` and `paged_attention_verify` (S > 1 query tokens)
against JAX's Pallas `paged_flash_decode` in interpret mode and against its
gather oracle, with pool blocks deliberately permuted through the pool.
Inputs are made from a numpy seed and handed to both packages.

Tolerances. Against JAX's oracle both sides run an f32 softmax over the same
bf16 (or bf16-dequantized int8) values and differ in summation order only:
one bf16 ulp (rtol 2^-7, atol 2^-8 near zero), as in
tests/test_torch_attention.py and tests/test_torch_kv_int8.py. JAX's Pallas
kernel rounds q * scale and the unnormalised p to bf16 and keeps a running
max (and, on an int8 pool, multiplies the scales into the scores instead of
dequantizing), a few bf16 ulps of |v| < 5: atol 2^-6, as the flash prefill
comparison of tests/test_torch_attention.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu.kernels.flash_decode import paged_flash_decode as jax_paged_flash_decode
from eetq_tpu.modules import paged as jax_paged
from eetq_tpu_torch.kernels.flash_decode import (
    flash_decode,
    flash_decode_int8,
    paged_flash_decode,
    paged_flash_decode_int8,
    paged_flash_decode_int8_ref,
    paged_flash_decode_ref,
)
from eetq_tpu_torch.modules.attention import (
    attention,
    attention_verify,
    init_kv_cache,
    update_cache,
)
from eetq_tpu_torch.modules.paged import (
    PagedKVCache,
    init_paged_kv_cache,
    paged_attention_decode,
    paged_attention_verify,
    paged_gather_dense,
    paged_insert_dense,
    paged_write,
    paged_write_multi,
)
from eetq_tpu_torch.utils.device import resolve

jax_attn = importlib.import_module("eetq_tpu.modules.attention")

B, HKV, D, BS = 2, 4, 32, 128
NB, MAXB = 16, 4
DTYPES = [(torch.bfloat16, jnp.bfloat16), (torch.int8, jnp.int8)]
IDS = ["bf16", "int8"]


def _both(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _table(rng, num_blocks=NB, batch=B, max_blocks=MAXB) -> np.ndarray:
    """Distinct, shuffled pool blocks per row."""
    return rng.permutation(num_blocks)[:batch * max_blocks].reshape(batch, max_blocks).astype(
        np.int32)


def _pair(table: np.ndarray, tdtype, jdtype, num_blocks=NB, hkv=HKV, d=D):
    """The same empty paged cache in both packages, with the given table."""
    b, mb = table.shape
    cj = jax_paged.init_paged_kv_cache(num_blocks, BS, hkv, d, b, mb, jdtype)
    cj = cj.__class__(**{**cj.__dict__, "table": jnp.asarray(table)})
    ct = init_paged_kv_cache(num_blocks, BS, hkv, d, b, mb, tdtype, device="cpu",
                             table=torch.from_numpy(table.copy()))
    return cj, ct


def _assert_pools_equal(ct, cj):
    names = ("k", "v", "k_scale", "v_scale") if ct.quantized else ("k", "v")
    for name in names:
        np.testing.assert_array_equal(_np(getattr(ct, name)), _np(getattr(cj, name)), name)


def test_device_default_is_the_card():
    """Nothing is allocated: only the resolved device is looked at."""
    assert resolve(None) == torch.device("cuda") and resolve().type == "cuda"
    assert resolve("cpu") == torch.device("cpu")
    assert resolve(torch.device("cuda", 0)) == torch.device("cuda", 0)


@pytest.mark.parametrize("tdtype,jdtype", DTYPES, ids=IDS)
def test_init_paged_kv_cache(tdtype, jdtype):
    c = init_paged_kv_cache(NB, BS, HKV, D, B, MAXB, tdtype, device="cpu")
    cj = jax_paged.init_paged_kv_cache(NB, BS, HKV, D, B, MAXB, jdtype)
    assert isinstance(c, PagedKVCache)
    assert c.k.shape == cj.k.shape == (NB, HKV, BS, D) and c.k.dtype == tdtype
    assert c.table.shape == cj.table.shape == (B, MAXB) and c.table.dtype == torch.int32
    assert (c.block_size, c.num_blocks) == (BS, NB) == (cj.block_size, cj.num_blocks)
    assert c.quantized == cj.quantized == (tdtype == torch.int8)
    if c.quantized:
        assert c.k_scale.shape == cj.k_scale.shape == (NB, HKV, BS)
        assert c.v_scale.dtype == torch.float32
    assert not c.k.any() and not c.table.any()


def test_init_paged_kv_cache_rejects_odd_block_and_table():
    for init in (jax_paged.init_paged_kv_cache,
                 lambda *a: init_paged_kv_cache(*a, device="cpu")):
        with pytest.raises(ValueError, match="multiple of 128"):
            init(NB, 96, HKV, D, B, MAXB)
    with pytest.raises(ValueError):  # a shared table of another shape
        init_paged_kv_cache(NB, BS, HKV, D, B, MAXB, device="cpu",
                            table=torch.zeros(B, MAXB + 1, dtype=torch.int32))


@pytest.mark.parametrize("tdtype,jdtype", DTYPES, ids=IDS)
def test_paged_write_bit_identical_to_jax(tdtype, jdtype):
    """Three decode writes per row, one row crossing a block edge; int8
    pools hold JAX's values and scales exactly (JAX quantizes under jit)."""
    rng = np.random.default_rng(1)
    cj, ct = _pair(_table(rng), tdtype, jdtype)
    write_j = jax.jit(jax_paged.paged_write)
    lengths = np.array([BS + 3, 2 * BS - 1], np.int32)
    for step in range(3):
        kj, kt = _both(rng.standard_normal((B, 1, HKV, D)).astype(np.float32) * 2)
        vj, vt = _both(rng.standard_normal((B, 1, HKV, D)).astype(np.float32) * 2)
        cj = write_j(cj, kj, vj, jnp.asarray(lengths + step))
        assert paged_write(ct, kt, vt, torch.from_numpy(lengths + step)) is ct  # in place
    _assert_pools_equal(ct, cj)
    assert ct.k.any()
    # an int position writes every row at that position
    kj, kt = _both(rng.standard_normal((B, 1, HKV, D)).astype(np.float32))
    cj = write_j(cj, kj, kj, jnp.int32(5))
    paged_write(ct, kt, kt, 5)
    _assert_pools_equal(ct, cj)


def test_paged_write_matches_dense_cache():
    """The pool, gathered through its table, holds what the dense cache
    holds at the written positions."""
    rng = np.random.default_rng(2)
    _, ct = _pair(_table(rng), torch.bfloat16, jnp.bfloat16)
    dense = init_kv_cache(B, MAXB * BS, HKV, D, device="cpu")
    pos = torch.tensor([BS - 1, 3 * BS + 7])
    for step in range(2):
        _, k = _both(rng.standard_normal((B, 1, HKV, D)).astype(np.float32))
        _, v = _both(rng.standard_normal((B, 1, HKV, D)).astype(np.float32))
        paged_write(ct, k, v, pos + step)
        update_cache(dense, k, v, pos + step)
    got = paged_gather_dense(ct, MAXB * BS)
    assert torch.equal(got.k, dense.k) and torch.equal(got.v, dense.v)


def test_inactive_rows_share_the_trash_block():
    """Rows whose table points at block 0 write over each other there; the
    other blocks stay untouched."""
    c = init_paged_kv_cache(4, BS, HKV, D, 3, 2, device="cpu")
    k = torch.randn(3, 1, HKV, D, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    paged_write(c, k, k, 1)
    assert c.k[0, :, 1].any() and not c.k[1:].any() and not c.k[0, :, 2:].any()


@pytest.mark.parametrize("tdtype,jdtype", DTYPES, ids=IDS)
def test_insert_gather_roundtrip_and_jax(tdtype, jdtype):
    """A dense row of two whole blocks goes into scattered pool blocks and
    comes back; the pools equal JAX's."""
    rng = np.random.default_rng(3)
    s = 2 * BS
    kj, kt = _both(rng.standard_normal((1, s, HKV, D)).astype(np.float32))
    vj, vt = _both(rng.standard_normal((1, s, HKV, D)).astype(np.float32))
    dj = jax.jit(jax_attn.update_cache)(
        jax_attn.init_kv_cache(1, s, HKV, D, dtype=jdtype), kj, vj, jnp.int32(0))
    dt = update_cache(init_kv_cache(1, s, HKV, D, dtype=tdtype, device="cpu"), kt, vt, 0)
    table = _table(rng)
    cj, ct = _pair(table, tdtype, jdtype)
    cj = jax_paged.paged_insert_dense(cj, dj, jnp.int32(0), jnp.asarray(table[0, :2]), 2)
    assert paged_insert_dense(ct, dt, 0, torch.from_numpy(table[0, :2]), 2) is ct
    _assert_pools_equal(ct, cj)
    out = paged_gather_dense(ct, 2 * BS)
    oj = jax_paged.paged_gather_dense(cj, 2 * BS)
    for name in ("k", "v") + (("k_scale", "v_scale") if ct.quantized else ()):
        assert torch.equal(getattr(out, name)[0], getattr(dt, name)[0]), name
        np.testing.assert_array_equal(_np(getattr(out, name)), _np(getattr(oj, name)), name)


@pytest.mark.parametrize("tdtype,jdtype", DTYPES, ids=IDS)
def test_insert_short_scratch_is_zero_padded(tdtype, jdtype):
    """A scratch of 128 positions handed off as two blocks: the second
    block is zeros, as in JAX."""
    rng = np.random.default_rng(4)
    kj, kt = _both(rng.standard_normal((1, BS, HKV, D)).astype(np.float32))
    dj = jax.jit(jax_attn.update_cache)(
        jax_attn.init_kv_cache(1, BS, HKV, D, dtype=jdtype), kj, kj, jnp.int32(0))
    dt = update_cache(init_kv_cache(1, BS, HKV, D, dtype=tdtype, device="cpu"), kt, kt, 0)
    table = _table(rng)
    cj, ct = _pair(table, tdtype, jdtype)
    ct.k.fill_(1)  # stale contents of the pool
    cj = jax_paged.paged_insert_dense(cj, dj, jnp.int32(0), jnp.asarray(table[1, :2]), 2)
    paged_insert_dense(ct, dt, 0, torch.from_numpy(table[1, :2]), 2)
    assert not ct.k[table[1, 1]].any() and ct.k[table[1, 0]].any()
    for blk in table[1, :2]:
        np.testing.assert_array_equal(_np(ct.k[blk]), _np(cj.k[blk]))


def test_insert_int8_pool_needs_int8_scratch():
    ct = init_paged_kv_cache(NB, BS, HKV, D, B, MAXB, torch.int8, device="cpu")
    dense = init_kv_cache(1, BS, HKV, D, device="cpu")
    with pytest.raises(ValueError, match="int8 dense scratch"):
        paged_insert_dense(ct, dense, 0, torch.tensor([1]), 1)


def _filled(rng, hq, hkv, tdtype, jdtype, lengths, d=D):
    """Both packages' paged caches holding the same MAXB * BS tokens per
    row behind a permuted table, the dense caches they were cut from, and a
    query."""
    b, s_full = len(lengths), MAXB * BS
    kj, kt = _both(rng.standard_normal((b, s_full, hkv, d)).astype(np.float32))
    vj, vt = _both(rng.standard_normal((b, s_full, hkv, d)).astype(np.float32))
    dj = jax.jit(jax_attn.update_cache)(
        jax_attn.init_kv_cache(b, s_full, hkv, d, dtype=jdtype), kj, vj, jnp.int32(0))
    dt = update_cache(init_kv_cache(b, s_full, hkv, d, dtype=tdtype, device="cpu"), kt, vt, 0)
    table = _table(rng, 32, b, MAXB)
    cj, ct = _pair(table, tdtype, jdtype, 32, hkv, d)
    for r in range(b):
        cj = jax_paged.paged_insert_dense(cj, dj, jnp.int32(r), jnp.asarray(table[r]), MAXB)
        paged_insert_dense(ct, dt, r, torch.from_numpy(table[r]), MAXB)
    qj, qt = _both(rng.standard_normal((b, 1, hq, d)).astype(np.float32))
    return cj, ct, dj, dt, qj, qt


@pytest.mark.parametrize("tdtype,jdtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_paged_decode_matches_jax_kernel_and_oracle(hq, hkv, tdtype, jdtype):
    """Per-row lengths that cross block edges (mid-block, a whole number of
    blocks, one token), blocks permuted through the pool."""
    rng = np.random.default_rng(hq + hkv)
    lengths = np.array([3 * BS + 17, 2 * BS, 1], np.int32)
    cj, ct, dj, dt, qj, qt = _filled(rng, hq, hkv, tdtype, jdtype, lengths)
    got = paged_attention_decode(qt, ct, torch.from_numpy(lengths))
    assert got.shape == (3, 1, hq, D) and got.dtype == torch.bfloat16
    kern_j = jax_paged_flash_decode(qj, cj, jnp.asarray(lengths), scale=D ** -0.5,
                                    interpret=True)
    np.testing.assert_allclose(_np(got), _np(kern_j), rtol=0, atol=2**-6)
    oracle_j = jax_paged.paged_attention_decode(qj, cj, jnp.asarray(lengths), use_kernel=False)
    np.testing.assert_allclose(_np(got), _np(oracle_j), rtol=2**-7, atol=2**-8)
    # use_kernel=False is the same plain computation on the CPU
    assert torch.equal(paged_attention_decode(qt, ct, torch.from_numpy(lengths),
                                              use_kernel=False), got)


@pytest.mark.parametrize("tdtype,jdtype", DTYPES, ids=IDS)
def test_paged_equals_dense_inside_the_port(tdtype, jdtype):
    """The paged wrappers on the pool give exactly what the dense wrappers
    give on the cache the pool was cut from; table entries past a row's
    length do not matter."""
    rng = np.random.default_rng(9)
    lengths = np.array([BS + 1, 4 * BS], np.int32)
    _, ct, _, dt, _, qt = _filled(rng, 8, 2, tdtype, jdtype, lengths)
    lt = torch.from_numpy(lengths)
    if ct.quantized:
        paged = paged_flash_decode_int8(qt, ct.k, ct.v, ct.k_scale, ct.v_scale, ct.table, lt)
        dense = flash_decode_int8(qt, dt.k, dt.v, dt.k_scale, dt.v_scale, lt)
        ref = paged_flash_decode_int8_ref(qt, ct.k, ct.v, ct.k_scale, ct.v_scale, ct.table, lt)
    else:
        paged = paged_flash_decode(qt, ct.k, ct.v, ct.table, lt)
        dense = flash_decode(qt, dt.k, dt.v, lt)
        ref = paged_flash_decode_ref(qt, ct.k, ct.v, ct.table, lt)
    assert torch.equal(paged, dense) and torch.equal(paged, ref)
    ct.table[0, 2:] = 0  # row 0 owns two blocks; the rest of its row is arbitrary
    assert torch.equal(paged_attention_decode(qt, ct, lt), paged)


@pytest.mark.parametrize("tdtype,jdtype", DTYPES, ids=IDS)
def test_attention_dispatches_on_a_paged_cache(tdtype, jdtype):
    """`attention` with S = 1 writes through the table and attends, as JAX's
    does; S > 1 raises in both packages."""
    rng = np.random.default_rng(11)
    lengths = np.array([BS - 1, 2 * BS + 5], np.int32)
    cj, ct, _, _, qj, qt = _filled(rng, 8, 4, tdtype, jdtype, lengths)
    kj, kt = _both(rng.standard_normal((B, 1, 4, D)).astype(np.float32))
    vj, vt = _both(rng.standard_normal((B, 1, 4, D)).astype(np.float32))
    oj, cj = jax.jit(jax_attn.attention, static_argnames=("decode_kernel",))(
        qj, kj, vj, cj, jnp.asarray(lengths), decode_kernel=False)
    for use in (True, False):
        ot, same = attention(qt, kt, vt, ct, torch.from_numpy(lengths), use_kernels=use)
        assert same is ct
        np.testing.assert_allclose(_np(ot), _np(oj), rtol=2**-7, atol=2**-8)
    _assert_pools_equal(ct, cj)
    with pytest.raises(NotImplementedError):
        attention(qt.expand(B, 2, 8, D), kt.expand(B, 2, 4, D), vt.expand(B, 2, 4, D), ct, 0)
    with pytest.raises(NotImplementedError):
        jax_attn.attention(jnp.tile(qj, (1, 2, 1, 1)), jnp.tile(kj, (1, 2, 1, 1)),
                           jnp.tile(vj, (1, 2, 1, 1)), cj, jnp.int32(0))


@pytest.mark.parametrize("tdtype,jdtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("s,hq,hkv", [(3, 4, 4), (8, 8, 2)], ids=["S3-mha", "S8-gqa"])
def test_paged_verify_matches_jax_kernel_and_oracle(s, hq, hkv, tdtype, jdtype):
    """The multi-query verify over a paged cache (query token i at
    length - S + i), blocks permuted through the pool: against JAX's paged
    Pallas kernel in its S > 1 mode (interpret) and its gather oracle, and
    equal to the port's dense verify on the cache the pool was cut from."""
    rng = np.random.default_rng(10 * s + hq)
    lengths = np.array([3 * BS + 17, 2 * BS, s], np.int32)
    cj, ct, _, dt, _, _ = _filled(rng, hq, hkv, tdtype, jdtype, lengths)
    qj, qt = _both(rng.standard_normal((3, s, hq, D)).astype(np.float32))
    lt = torch.from_numpy(lengths)
    got = paged_attention_verify(qt, ct, lt)
    assert got.shape == (3, s, hq, D)
    kern_j = jax_paged_flash_decode(qj, cj, jnp.asarray(lengths), scale=D ** -0.5,
                                    interpret=True)
    np.testing.assert_allclose(_np(got), _np(kern_j), rtol=0, atol=2**-6)
    oracle_j = jax_paged.paged_attention_verify(qj, cj, jnp.asarray(lengths), use_kernel=False)
    np.testing.assert_allclose(_np(got), _np(oracle_j), rtol=2**-7, atol=2**-8)
    assert torch.equal(got, attention_verify(qt, dt, lt))


@pytest.mark.parametrize("tdtype,jdtype", DTYPES, ids=IDS)
def test_attention_verify_on_a_paged_cache(tdtype, jdtype):
    """`attention(verify=True)` over a paged cache writes S tokens a row
    through the table (across a block edge) and attends, as JAX's
    `paged_write_multi` and `paged_attention_verify` do."""
    rng = np.random.default_rng(12)
    s = 4
    lengths = np.array([BS - 2, 2 * BS + 5], np.int32)  # row 0's tokens straddle a block edge
    cj, ct, _, _, _, _ = _filled(rng, 8, 4, tdtype, jdtype, lengths)
    qj, qt = _both(rng.standard_normal((B, s, 8, D)).astype(np.float32))
    kj, kt = _both(rng.standard_normal((B, s, 4, D)).astype(np.float32))
    vj, vt = _both(rng.standard_normal((B, s, 4, D)).astype(np.float32))
    oj, cj = jax.jit(jax_attn.attention, static_argnames=("verify", "decode_kernel"))(
        qj, kj, vj, cj, jnp.asarray(lengths), verify=True, decode_kernel=False)
    ot, same = attention(qt, kt, vt, ct, torch.from_numpy(lengths), verify=True)
    assert same is ct
    np.testing.assert_allclose(_np(ot), _np(oj), rtol=2**-7, atol=2**-8)
    _assert_pools_equal(ct, cj)
    ct2 = PagedKVCache(*(t.clone() for t in (ct.k, ct.v, ct.table)),
                       *(None if t is None else t.clone() for t in (ct.k_scale, ct.v_scale)))
    paged_write_multi(ct2, kt, vt, torch.from_numpy(lengths))
    _assert_pools_equal(ct2, cj)
