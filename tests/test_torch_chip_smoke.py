"""`chip_smoke.py`'s check of ptxas's `wgmma` serialization (warning C7520)
on build logs written as `kernels/_build.py` writes them: one "== source"
line, then that source's `-Xptxas=-v` output."""

import chip_smoke

_WARN = ("ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions "
         "are serialized due to program dependence on compiler-inserted WG.AR in divergent "
         "path in the function '{}'")
_LOG = "\n".join([
    "== w8a16_gemm.cu",
    "ptxas info    : Compiling entry function '_ZN4eetq10wgmma_gemm11gemm_kernelILi8EEEv' "
    "for 'sm_90a'",
    "ptxas info    : Used 128 registers, used 2 barriers",
    "== w8a16_grouped_gemm.cu",
    _WARN.format("_ZN4eetq13wgmma_grouped14grouped_kernelILi8ELi8ELi2EEEv"),
    _WARN.format("_ZN4eetq13wgmma_grouped14grouped_kernelILi8ELi16ELi2EEEv"),
    "== w8a8_gemm.cu",
    "ptxas info    : Used 128 registers, used 3 barriers",
])


def test_serialized_wgmma_lists_kernels_by_source():
    assert chip_smoke.serialized_wgmma(_LOG) == {
        "w8a16_grouped_gemm.cu": ["_ZN4eetq13wgmma_grouped14grouped_kernelILi8ELi8ELi2EEEv",
                                  "_ZN4eetq13wgmma_grouped14grouped_kernelILi8ELi16ELi2EEEv"],
    }
    assert not set(chip_smoke.serialized_wgmma(_LOG)) & set(chip_smoke.UNSERIALIZED_SOURCES)


def test_serialized_wgmma_flags_the_dense_gemms():
    log = _LOG + "\n== w4a8_gemm.cu\n" + _WARN.format("_ZN4eetq2a814a8_gemm_kernelILi4EEEv")
    found = chip_smoke.serialized_wgmma(log)
    assert set(found) & set(chip_smoke.UNSERIALIZED_SOURCES) == {"w4a8_gemm.cu"}
    assert chip_smoke.serialized_wgmma("== w8a8_gemm.cu\nptxas info : 0 bytes gmem") == {}


_USAGE_LOG = "\n".join([
    "== flash_attention.cu",
    "ptxas info    : Compiling entry function "
    "'_ZN12_GLOBAL__N_126flash_attention_fwd_kernelILi256ELi1ELb0ELb0EEEvPK' for 'sm_90a'",
    "ptxas info    : Function properties for "
    "_ZN12_GLOBAL__N_126flash_attention_fwd_kernelILi256ELi1ELb0ELb0EEEvPK",
    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
    "ptxas info    : Used 218 registers, used 1 barriers, 472 bytes cmem[0]",
    "ptxas info    : Compiling entry function "
    "'_ZN12_GLOBAL__N_126flash_attention_fwd_kernelILi128ELi2ELb0ELb0EEEvPK' for 'sm_90a'",
    "ptxas info    : Function properties for "
    "_ZN12_GLOBAL__N_126flash_attention_fwd_kernelILi128ELi2ELb0ELb0EEEvPK",
    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
    "ptxas info    : Used 189 registers, used 1 barriers, 472 bytes cmem[0]",
    "== flash_decode.cu",
    "ptxas info    : Compiling entry function "
    "'_ZN12_GLOBAL__N_119flash_decode_kernelILi8ELi1ELi256ELb1ELb0ELb0ELb0EEEv6Params' for 'sm_90a'",
    "ptxas info    : Function properties for "
    "_ZN12_GLOBAL__N_119flash_decode_kernelILi8ELi1ELi256ELb1ELb0ELb0ELb0EEEv6Params",
    "    16 bytes stack frame, 12 bytes spill stores, 32 bytes spill loads",
    "ptxas info    : Used 255 registers, used 1 barriers, 544 bytes cmem[0]",
])


def test_ptxas_usage_reads_registers_and_spills():
    usage = chip_smoke.ptxas_usage(_USAGE_LOG)
    assert len(usage) == 3
    assert usage["_ZN12_GLOBAL__N_126flash_attention_fwd_kernelILi128ELi2ELb0ELb0EEEvPK"] == (
        189, 0, 0)
    assert usage["_ZN12_GLOBAL__N_119flash_decode_kernelILi8ELi1ELi256ELb1ELb0ELb0ELb0EEEv6Params"
                 ] == (255, 12, 32)


def test_head256_usage_keeps_the_head_dim_256_instances():
    got = chip_smoke.head256_usage(_USAGE_LOG)
    assert got == {
        "flash_attention_fwd_kernel": dict(instances=1, min_registers=218, max_registers=218,
                                           max_spill_stores=0, max_spill_loads=0, spilling=0),
        "flash_decode_kernel": dict(instances=1, min_registers=255, max_registers=255,
                                    max_spill_stores=12, max_spill_loads=32, spilling=1),
    }


def test_flash_attention_source_must_not_serialize_wgmma():
    log = _LOG + "\n== flash_attention.cu\n" + _WARN.format(
        "_ZN12_GLOBAL__N_126flash_attention_fwd_kernelILi256ELi2ELb0ELb0EEEvPK")
    assert set(chip_smoke.serialized_wgmma(log)) & set(chip_smoke.UNSERIALIZED_SOURCES) == {
        "flash_attention.cu"}


def test_unit_gain_norms_zeroes_only_unit_offset_norms():
    """A unit-offset (gemma) random model's stored norms go to 0, gain 1;
    another preset's stay at the initializer's ones."""
    import dataclasses

    import torch

    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.init import random_dense_params

    base = dataclasses.replace(PRESETS["toy"], num_layers=1)
    for offset in (False, True):
        cfg = dataclasses.replace(base, rmsnorm_unit_offset=offset)
        params = random_dense_params(cfg, torch.Generator().manual_seed(0))
        chip_smoke.unit_gain_norms(params, cfg)
        norms = [params.final_norm, params.layers[0].input_norm, params.layers[0].post_norm]
        assert all(torch.equal(n, torch.full_like(n, 0.0 if offset else 1.0)) for n in norms)


def test_preset_paths_name_their_models_kernels():
    """The presets phase's paths (PRESET_MODELS): each preset of
    `models/config.py` that no other phase builds, its linear kernels at its
    bits (llama2-70b's int4 GEMV, GEMM and W4A8 admission), its decode
    kernel by KV dtype, its engine's by pool and KV dtype, and no attention
    variant: the checks of `check_launches` then hold every other kernel at
    0."""
    from eetq_tpu_torch.models.config import PRESETS

    others = set(chip_smoke.FAMILIES) | {chip_smoke.MODEL, chip_smoke.MIXTRAL, "toy", "toy-moe"}
    assert set(chip_smoke.PRESET_MODELS) == set(PRESETS) - others
    assert list(chip_smoke.PRESET_MODELS)[-1] == "llama2-70b"  # the largest, last
    paths = chip_smoke._family_paths(chip_smoke.PRESET_MODELS)
    assert paths["llama70b_decode"] == ("w4a16_gemv", "w4a16_gemm", "flash_attention_fwd",
                                        "flash_decode_int8")
    assert paths["llama70b_paged_server"] == ("w4a16_gemv", "w4a8_gemm", "flash_attention_fwd",
                                              "paged_flash_decode_int8")
    assert paths["llama13b_decode"][-1] == "fused_mlp_gemv"
    assert paths["llama3_paged_server"][-1] == "paged_flash_decode"
    assert paths["tinyllama_paged_server"][-1] == "paged_flash_decode_int8"
    assert set(paths["baichuan7_server"]) == set(chip_smoke.PATH_KERNELS["server"])
    assert len(paths) == 2 * len(chip_smoke.PRESET_MODELS)
    assert not any("[" in k for kernels in paths.values() for k in kernels)
    assert all(chip_smoke.PATH_KERNELS[p] == k for p, k in paths.items())
    assert "presets" in chip_smoke.PHASES
