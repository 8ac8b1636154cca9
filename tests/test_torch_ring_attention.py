"""Ring attention (`eetq_tpu_torch/dist/ring_attention.py`) against the JAX
package on the CPU (`tests/test_ring_attention.py`): the port's
`ring_attention_sharded` runs in spawned gloo ranks (a pool of 4 and one of
8 for the module, `tests/torch_pipeline_tasks.py::ring`), JAX's on the fake
CPU devices of `tests/conftest.py`; both are held against JAX's full
attention (`attention_reference`), and the port against JAX's ring, at the
JAX test's 3e-2 (bf16 inputs; both rings run the statistics in f32 over the
exact bf16 products, in other summation orders). The ranks' gathered
outputs are identical, and each rank makes 2 p ppermutes (k and v at each
of the p steps, JAX's `scan` body times its trip count) and one gather of
the output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

import torch_pipeline_tasks as tasks
from eetq_tpu.dist.ring_attention import ring_attention_sharded as jax_ring
from eetq_tpu.modules.attention import attention_reference, causal_mask
from eetq_tpu.ops.alibi import alibi_slopes
from eetq_tpu_torch.dist.launch import RankPool
from test_torch_pipeline import _jax_counts

TOL = 3e-2


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {}

    def get(world: int) -> RankPool:
        if world not in made:
            rdv = tmp_path_factory.mktemp(f"rdv{world}") / "store"
            made[world] = RankPool(world, f"file://{rdv}", device="cpu", threads=1,
                                   timeout_s=300)
        return made[world]

    yield get
    for pool in made.values():
        pool.close()


def _mesh(p):
    return JaxMesh(np.asarray(jax.devices()[:p]).reshape(1, p), ("data", "model"))


def _qkv(seed, b, s, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32) for h in (hq, hkv, hkv))


def _check(pools, p, q, k, v, causal=True, window=None, slopes=None):
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    jslopes = None if slopes is None else jnp.asarray(slopes)
    want = np.asarray(jax_ring(*bf, _mesh(p), causal=causal, window=window, slopes=jslopes),
                      np.float32)
    s, d = q.shape[1], q.shape[-1]
    mask = causal_mask(s, window=window) if causal else None
    full = np.asarray(attention_reference(*bf, mask, 1.0 / d ** 0.5, slopes=jslopes), np.float32)
    res = pools(p).run(tasks.ring, q, k, v, causal, slopes, window)
    for r in res[1:]:
        np.testing.assert_array_equal(r["out"], res[0]["out"])
    np.testing.assert_allclose(res[0]["out"], want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(res[0]["out"], full, atol=TOL, rtol=TOL)
    counts = _jax_counts(lambda a, b, c: jax_ring(a, b, c, _mesh(p), causal=causal,
                                                  window=window, slopes=jslopes), *bf)
    chunk = q.shape[0] * (s // p) * k.shape[2] * d * 2
    assert counts == {"ppermute": 2 * p * chunk, "ppermute_count": 2 * p}, counts
    for r in res:
        assert r["counts"] == {**counts, "all_gather": q.shape[0] * (s // p) * q.shape[2] * d * 2,
                               "all_gather_count": 1}, r["counts"]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_matches_jax_and_full_attention(pools, causal, hq, hkv):
    """4-way ring, causal and full, MHA and GQA 8/2
    (`tests/test_ring_attention.py:27-44`)."""
    _check(pools, 4, *_qkv(0, 2, 64, hq, hkv, 16), causal=causal)


def test_eight_way(pools):
    """An 8-way ring over 8 ranks (`tests/test_ring_attention.py:47-66`)."""
    _check(pools, 8, *_qkv(1, 1, 128, 4, 2, 32))


def test_sliding_window(pools):
    """A window of 24 over 16-token chunks: the window crosses chunk
    boundaries and chunks before every local query's window are skipped
    (`tests/test_ring_attention.py:69-86`)."""
    _check(pools, 4, *_qkv(2, 2, 64, 4, 2, 16), window=24)


def test_alibi(pools):
    """ALiBi slopes in global positions across the chunks
    (`tests/test_ring_attention.py:89-105`)."""
    _check(pools, 4, *_qkv(3, 1, 64, 4, 2, 16), slopes=alibi_slopes(4))
