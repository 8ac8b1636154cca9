"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper in `KERNELS` launches its CUDA kernel for CUDA tensors (or
raises) and runs its plain version for CPU tensors; its `launches`
attribute counts kernel launches.
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


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
