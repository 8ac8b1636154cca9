"""The operation and byte counts against Mistral-7B and Mixtral-8x7B's
layers worked by hand."""

import json
from pathlib import Path

import pytest

from servebench import costs

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
MISTRAL = json.loads((CONFIGS / "mistral-7b.json").read_text())
MIXTRAL = json.loads((CONFIGS / "mixtral-8x7b.json").read_text())
H100 = {"hbm_bytes_s": 3.35e12, "bf16_flops": 989e12, "int8_ops": 1979e12}


def test_token_flops():
    # per layer: qkv 4096 x 6144, o 4096 x 4096, gate|up 4096 x 28672, down 14336 x 4096
    dense_layer = 2 * 4096 * (6144 + 4096 + 28672 + 14336)
    head = 2 * 4096 * 32000
    assert costs.token_flops(MISTRAL, 0) == 32 * dense_layer + head == 14_220_787_712
    # attention: q.k and p.v over each key, 32 heads of 128; the window caps the keys
    assert costs.token_flops(MISTRAL, 100) - costs.token_flops(MISTRAL, 0) == 32 * 4 * 32 * 128 * 100
    assert costs.token_flops(MISTRAL, 5000) == costs.token_flops(MISTRAL, 4096)
    # mixtral: qkv and o, the router, two experts of gate|up and down
    moe_layer = 2 * 4096 * (6144 + 4096) + 2 * 4096 * 8 + 2 * 2 * (4096 * 28672 + 14336 * 4096)
    assert costs.token_flops(MIXTRAL, 0) == 32 * moe_layer + head == 25_497_174_016
    assert costs.token_flops(MIXTRAL, 5000) > costs.token_flops(MIXTRAL, 4096)


def test_rows_flops_sums_the_steps():
    want = sum(costs.token_flops(MISTRAL, 300 + j + 1) for j in range(8))
    assert costs.rows_flops(MISTRAL, 300, 8) == pytest.approx(want, rel=1e-12)
    want = sum(costs.token_flops(MISTRAL, 4090 + j + 1) for j in range(16))
    assert costs.rows_flops(MISTRAL, 4090, 16) == pytest.approx(want, rel=1e-12)
    assert costs.rows_flops(MIXTRAL, 10, 0) == 0


def test_decode_bytes_bound_one_row():
    # weights once, f32 scales, a bf16 row in and out, per projection
    per_layer = (4096 * 53248 + 4 * (6144 + 4096 + 28672 + 4096)
                 + 2 * (4096 + 4096 + 4096 + 14336) + 2 * (6144 + 4096 + 28672 + 4096))
    assert costs.decode_linear_least_s(MISTRAL, 1, H100) == pytest.approx(32 * per_layer / 3.35e12)


def test_expected_experts():
    assert costs.distinct_experts(MIXTRAL, 1) == pytest.approx(2.0)
    assert costs.distinct_experts(MIXTRAL, 32) == pytest.approx(8 * (1 - 0.75 ** 32))
    assert costs.distinct_experts(MISTRAL, 32) == 0.0
    one = (2.0 * (4096 * 28672 + 28672 * 4) + 2 * (4096 + 28672) * 2
           + 2.0 * (14336 * 4096 + 4096 * 4) + 2 * (14336 + 4096) * 2)
    attn = 4096 * 10240 + 4 * 10240 + 2 * (4096 + 4096) + 2 * (6144 + 4096)
    assert costs.decode_linear_least_s(MIXTRAL, 1, H100) == pytest.approx(32 * (one + attn) / 3.35e12)


def test_admission_bound():
    n = 1024
    got = costs.admission_least_s(MISTRAL, n, H100)
    ops = 2 * n * 4096 * 53248
    assert got["linear"] == pytest.approx(32 * ops / 1979e12, rel=1e-3)  # int8 operations bind
    pairs = n * (n + 1) // 2
    other = 32 * 4 * 32 * 128 * pairs / 989e12 + 2 * 4096 * 32000 / 989e12
    assert got["all"] - got["linear"] == pytest.approx(other)


@pytest.mark.parametrize("lens", [[1, 17, 300], [5000, 100]])
def test_decode_cost_is_chip_smokes(lens):
    # the frozen copy keeps chip_smoke.py's arithmetic
    b, ops = costs.decode_cost(lens, 32, 8, 1, 4, window=4096)
    keys = sum(min(n, 4096) for n in lens)
    assert b == keys * 8 * 2 * (128 + 4) + len(lens) * (2 * 32 * 128 * 2 + 4)
    assert ops == 4.0 * 32 * 128 * keys
