"""The sharded path's edges on the CPU (`eetq_tpu_torch/dist/`): a mesh of
one rank is the plain model; what the JAX package refuses the port refuses
with the same exception; a world that cannot meet raises; a rank that fails
or hangs fails the call (`dist/launch.py::RankPool`). The parity of the
shards and the sharded forwards is `tests/test_torch_sharding.py`."""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

import torch_sharding_tasks as tasks
from eetq_tpu.dist import make_mesh as jax_make_mesh
from eetq_tpu.dist import shard_model as jax_shard_model
from eetq_tpu.models import PRESETS as JAX_PRESETS
from eetq_tpu.models import random_dense_params as jax_random_dense_params
from eetq_tpu.surgery import tp_reshard as jax_tp
from eetq_tpu_torch.dist import multihost
from eetq_tpu_torch.dist.launch import RankPool
from eetq_tpu_torch.dist.sharding import Mesh, make_forward_fn, make_mesh, shard_model
from eetq_tpu_torch.models.config import PRESETS
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.models.init import quantize_params
from eetq_tpu_torch.models.transformer import forward_inner, init_caches
from eetq_tpu_torch.modules.linear import quantize_linear
from eetq_tpu_torch.surgery import tp_reshard
from test_torch_model import jax_params_to_numpy

B, S = 2, 12


@pytest.fixture(scope="module")
def tree():
    """TOY's bf16 dense weights from JAX, as a numpy tree."""
    jp = jax_random_dense_params(JAX_PRESETS["toy"], jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    return jax_params_to_numpy(jp)


def test_one_rank_mesh_is_the_plain_model(tree):
    """Without a process group make_mesh is one rank: the sharded forward is
    the plain forward, bit for bit, with no collective."""
    cfg = PRESETS["toy"]
    params = params_from_numpy(tree, device="cpu")
    model = shard_model(params, cfg, make_mesh(device="cpu"))
    plain = quantize_params(params)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(3))
    pos = torch.arange(S).expand(B, S)
    got, _ = make_forward_fn(model)(model.params, toks, pos, model.init_caches(B, S), 0)
    want, _ = forward_inner(plain, cfg, toks, pos, init_caches(cfg, B, S, device="cpu"), 0)
    assert torch.equal(got, want)


def test_refusals_match_jax(tree):
    """What JAX refuses, the port refuses with the same exception: a
    row-parallel bias, heads or experts that tp does not divide, MoE in
    shard_quantized; and a dp or a tp whose mesh is not the world size (one
    rank here), and a quantized lm_head in shard_model."""
    cfg = PRESETS["toy"]
    two = Mesh(tp=2, rank=0, device=torch.device("cpu"))
    params = params_from_numpy(tree, device="cpu")
    biased = params_from_numpy(tree, device="cpu")
    biased.layers[0].o_proj.bias = torch.zeros(cfg.hidden_size, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="row-parallel bias"):
        shard_model(biased, cfg, two)
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        shard_model(params, cfg, Mesh(tp=3, rank=0, device=torch.device("cpu")))
    jp = jax_random_dense_params(JAX_PRESETS["toy"], jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    with pytest.raises(ValueError):
        jax_shard_model(jp, JAX_PRESETS["toy"], jax_make_mesh(tp=8, dp=1))
    moe_cfg = dataclasses.replace(PRESETS["toy-moe"], num_experts=3)
    jmoe_cfg = dataclasses.replace(JAX_PRESETS["toy-moe"], num_experts=3)
    jmoe = jax_random_dense_params(jmoe_cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    with pytest.raises(ValueError, match="num_experts 3 not divisible by tp=2"):
        jax_shard_model(jmoe, jmoe_cfg, jax_make_mesh(tp=2, dp=1))
    with pytest.raises(ValueError, match="num_experts 3 not divisible by tp=2"):
        shard_model(params_from_numpy(jax_params_to_numpy(jmoe), device="cpu"), moe_cfg, two)
    moe = params_from_numpy(jax_params_to_numpy(jmoe), device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        tp_reshard.shard_quantized(quantize_params(moe), moe_cfg, two)
    with pytest.raises(NotImplementedError, match="MoE"):
        jax_tp.shard_quantized(jmoe, jmoe_cfg, jax_make_mesh(tp=1, dp=1))
    with pytest.raises(ValueError, match="world size 1"):  # dp tp must be the world
        make_mesh(dp=2, device="cpu")
    with pytest.raises(ValueError, match="world size 1"):
        make_mesh(tp=2, device="cpu")
    params.lm_head = quantize_linear(params.lm_head.weight)
    with pytest.raises(ValueError, match="keeps the lm_head dense"):
        shard_model(params, cfg, two)


def test_a_world_that_cannot_meet_raises(tmp_path):
    """initialize() of a world of 2 raises without a rendezvous, and when its
    partner never comes (after timeout_s), instead of going on alone."""
    with pytest.raises(RuntimeError, match="no rendezvous"):
        multihost.initialize(rank=0, world_size=2)
    code = ("import sys\nfrom eetq_tpu_torch.dist import multihost\n"
            f"multihost.initialize(0, 2, 'file://{tmp_path}/store', 'gloo', timeout_s=3)\n"
            "print('JOINED ALONE')\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert run.returncode != 0 and "JOINED ALONE" not in run.stdout, run.stdout


def test_a_failed_or_hung_rank_fails_the_call(tmp_path):
    """A task that raises on a rank raises in the parent with its traceback;
    one that outlives the pool's timeout raises TimeoutError. Either closes
    the pool."""
    pool = RankPool(2, f"file://{tmp_path}/a", device="cpu", threads=1, timeout_s=60)
    with pytest.raises(RuntimeError, match="(?s)rank [01] failed:.*boom"):
        pool.run(tasks.fail, "boom")
    with pytest.raises(RuntimeError, match="closed"):
        pool.run(tasks.sleep, 0)
    pool = RankPool(2, f"file://{tmp_path}/b", device="cpu", threads=1, timeout_s=60)
    pool.timeout_s = 4  # the parent's wait; the ranks started under the longer one
    with pytest.raises(TimeoutError):
        pool.run(tasks.sleep, 60)
