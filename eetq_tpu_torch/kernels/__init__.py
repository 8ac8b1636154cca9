"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper in `KERNELS` launches its CUDA kernel for CUDA tensors (or
raises) and runs its plain version for CPU tensors; its `launches`
attribute counts kernel launches; the attention kernels also count the
launches of each variant they ran (`variant_launches`: a sliding window,
ALiBi, a GQA group other than 1, 2, 4, 8, head dim 256), read as
"name[variant]". A CUDA graph that replays captured launches adds the
counts of its capture on each replay (`add_launch_counts`, called by
`serve/graph.py`).
"""

from eetq_tpu_torch.kernels.flash_attention import flash_attention
from eetq_tpu_torch.kernels.flash_decode import (
    flash_decode,
    flash_decode_int8,
    paged_flash_decode,
    paged_flash_decode_int8,
)
from eetq_tpu_torch.kernels.mlp_fused import fused_mlp_gemv, fused_mlp_gemv_i4
from eetq_tpu_torch.kernels.w8a8 import w4a8_gemm, w8a8_gemm
from eetq_tpu_torch.kernels.w8a16 import (
    w4a16_expert_gemv,
    w4a16_gemm,
    w4a16_gemv,
    w4a16_grouped_gemm,
    w8a16_expert_gemv,
    w8a16_gemm,
    w8a16_gemv,
    w8a16_grouped_gemm,
)

KERNELS = {
    "w8a16_gemv": w8a16_gemv,
    "w8a16_gemm": w8a16_gemm,
    "flash_attention_fwd": flash_attention,
    "flash_decode": flash_decode,
    "w8a8_gemm": w8a8_gemm,
    "fused_mlp_gemv": fused_mlp_gemv,
    "flash_decode_int8": flash_decode_int8,
    "w8a16_expert_gemv": w8a16_expert_gemv,
    "w8a16_grouped_gemm": w8a16_grouped_gemm,
    "w4a16_gemv": w4a16_gemv,
    "w4a16_gemm": w4a16_gemm,
    "fused_mlp_gemv_i4": fused_mlp_gemv_i4,
    "w4a8_gemm": w4a8_gemm,
    "paged_flash_decode": paged_flash_decode,
    "paged_flash_decode_int8": paged_flash_decode_int8,
    "w4a16_expert_gemv": w4a16_expert_gemv,
    "w4a16_grouped_gemm": w4a16_grouped_gemm,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        for variant in getattr(fn, "variant_launches", ()):
            fn.variant_launches[variant] = 0


def launch_counts() -> dict[str, int]:
    """{wrapper name: launches}, and {"name[variant]": launches} of the
    attention kernels' variants."""
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    for name, fn in KERNELS.items():
        for variant, n in getattr(fn, "variant_launches", {}).items():
            counts[f"{name}[{variant}]"] = n
    return counts


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add `counts` (as `launch_counts` gives them) to the wrappers' counters."""
    for key, n in counts.items():
        name, _, variant = key.partition("[")
        if variant:
            KERNELS[name].variant_launches[variant[:-1]] += n
        else:
            KERNELS[name].launches += n
