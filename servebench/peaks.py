"""Datasheet peaks of the cards the benchmark runs on, frozen here so that
no change to the program moves the yardstick.

NVIDIA H100 SXM (the "NVIDIA H100 80GB HBM3" of `torch.cuda.get_device_name`),
NVIDIA's data sheet, dense rates without sparsity, at the 700 W power limit:
3.35 TB/s of HBM3, 989 TFLOP/s in bf16 on the tensor cores, 1,979 TOP/s in
int8. The same numbers as the program's `utils/profiling.py::CHIP_PEAKS`.
"""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_s": 3.35e12, "bf16_flops": 989e12, "int8_ops": 1979e12},
}


def peaks(card: str) -> dict:
    if card not in PEAKS:
        raise KeyError(f"no datasheet peaks for {card!r} in servebench/peaks.py")
    return PEAKS[card]
