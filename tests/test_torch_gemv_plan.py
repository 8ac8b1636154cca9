"""The decode GEMV's launch plan (`kernels/autotune.py::gemv_splits`): how
many K ranges each launch is split into, and the scratch the split needs.
Pure functions of the shapes and the SM count, so they run on the CPU."""

import math

import pytest

from eetq_tpu_torch.kernels import autotune
from eetq_tpu_torch.kernels.autotune import (
    FUSED_MLP_SLICE,
    GEMV_BLOCK_N,
    GEMV_BLOCKS_PER_SM,
    GEMV_MIN_SPLIT_STEPS,
    GEMV_SMEM_BYTES,
    GEMV_STEP_ROWS,
    MAX_DECODE_M,
    gemv_scratch_size,
    gemv_splits,
)

H100_SMS = 132
# (weight rows, strips, selections, bits): llama2-7b's qkv, o_proj, the fused
# MLP's gate/up (64 intermediate columns a block) and down, the lm_head;
# Mixtral-8x7B's expert gather (gate|up and down at b=1 and b=4)
LLAMA = {"qkv": (4096, 96, 1), "o": (4096, 32, 1), "gate_up": (4096, 172, 1),
         "down": (11008, 32, 1), "lm_head": (4096, 250, 1)}
MIXTRAL = {"gate_up b=1": (4096, 224, 2), "down b=1": (14336, 32, 2),
           "gate_up b=4": (4096, 224, 8), "down b=4": (14336, 32, 8)}


def _rows(k, bits):
    return k // 2 if bits == 4 else k


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 8])
def test_llama_shapes_fill_the_card_in_one_wave(bits, m):
    want = {"qkv": 2, "o": 8, "gate_up": 1, "down": 8, "lm_head": 1}
    for name, (k, strips, sels) in LLAMA.items():
        splits = gemv_splits(_rows(k, bits), strips, sels, bits, m, 0, H100_SMS)
        assert splits == want[name], name
        assert strips * sels * splits <= GEMV_BLOCKS_PER_SM * H100_SMS


@pytest.mark.parametrize("m", [1, 2, 8])
def test_mixtral_gather_splits_the_long_down_projection(m):
    got = {name: gemv_splits(k, strips, sels, 8, m, 0, H100_SMS)
           for name, (k, strips, sels) in MIXTRAL.items()}
    assert got["gate_up b=1"] == 1 and got["gate_up b=4"] == 1
    assert got["down b=1"] == 4  # 64 strips x selections fill 256 of 264 slots
    # b=4: 256 strips x selections fill the card; at m = 8 x [8, 14336] in
    # bf16 (229 KB) must still be staged in three ranges
    assert got["down b=4"] == (3 if m == 8 else 1)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k,group", [(k, g) for k in (1024, 4096, 11008, 14336, 28672)
                                     for g in (0, 32, 64, 96, 128) if not g or k % g == 0])
@pytest.mark.parametrize("m", [1, 3, MAX_DECODE_M])
def test_a_block_stages_what_fits_its_share_of_shared_memory(bits, k, group, m):
    rows = _rows(k, bits)
    steps = rows // GEMV_STEP_ROWS
    splits = gemv_splits(rows, 1000, 1, bits, m, group, H100_SMS)  # many strips: no fill split
    assert 1 <= splits <= steps
    per_row = 2 * m + (4 * GEMV_BLOCK_N / group if group else 0)
    step_k = GEMV_STEP_ROWS * (2 if bits == 4 else 1)
    longest = math.ceil(steps / splits) * step_k
    assert (longest - step_k) * per_row <= GEMV_SMEM_BYTES
    if splits > 1:  # one range fewer would not fit
        assert k * per_row > (splits - 1) * GEMV_SMEM_BYTES


@pytest.mark.parametrize("rows,strips", [(64, 3), (512, 3), (2048, 1), (4096, 32)])
def test_short_ranges_are_not_split_further(rows, strips):
    splits = gemv_splits(rows, strips, 1, 8, 1, 0, H100_SMS)
    assert splits == max(1, min(rows // GEMV_STEP_ROWS // GEMV_MIN_SPLIT_STEPS,
                                GEMV_BLOCKS_PER_SM * H100_SMS // strips))
    assert rows // GEMV_STEP_ROWS // splits >= min(GEMV_MIN_SPLIT_STEPS, rows // GEMV_STEP_ROWS)


def test_scratch_sizes():
    assert gemv_scratch_size(1, 96, 1) == (0, 0)
    assert gemv_scratch_size(8, 32, 1) == (8 * 32 * MAX_DECODE_M * GEMV_BLOCK_N, 32)
    assert gemv_scratch_size(4, 32, 2) == (2 * 4 * 32 * MAX_DECODE_M * GEMV_BLOCK_N, 64)


@pytest.mark.parametrize("args", [(100, 1, 1, 8, 1, 0), (0, 1, 1, 8, 1, 0), (128, 0, 1, 8, 1, 0),
                                  (128, 1, 0, 8, 1, 0), (128, 1, 1, 8, 0, 0),
                                  (128, 1, 1, 8, MAX_DECODE_M + 1, 0)])
def test_bad_launches_raise(args):
    with pytest.raises(ValueError):
        gemv_splits(*args, H100_SMS)


def test_the_kernel_is_compiled_with_the_plan_units():
    defines = autotune.compile_defines()
    assert f"-DEETQ_GEMV_BLOCK_N={GEMV_BLOCK_N}" in defines
    assert f"-DEETQ_GEMV_STEP_ROWS={GEMV_STEP_ROWS}" in defines
    assert 2 * FUSED_MLP_SLICE == GEMV_BLOCK_N  # 64 gate + 64 up columns a block
