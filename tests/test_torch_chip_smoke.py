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
