#!/usr/bin/env python3
"""One engine admission's logits on a CUDA card (the PyTorch port): the
kernel path against the plain path, under W8A8 and W8A16 prefill, for a
preset at full width and depth with random W8A16 weights from a seed.

Run from the repository root, on a machine with an H100:

    python3 scripts/torch_a8_admission.py [--preset baichuan-13b] [--seed 0]

The prompt is 700 seeded tokens right-padded to a 1024-token bucket, as
`chip_smoke.py`'s server phases admit one. Printed, as the error over the
largest logit: the kernel path against the plain path under W8A8 and
W8A16; for an ALiBi preset the same with rope in place of ALiBi on the
same weights; and under W8A8 against a plain path whose prefill attention
rounds as the flash kernel does (q * scale and p in bf16:
`kernels/flash_attention.py::flash_attention_ref`). It tells a kernel's
defect (gone against its own rounding) from the model's amplification of
ulp-level differences (not gone).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.init import random_quantized_params
    from eetq_tpu_torch.models.transformer import forward_inner, init_caches
    from eetq_tpu_torch.modules import attention

    fa = importlib.import_module("eetq_tpu_torch.kernels.flash_attention")
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--preset", default="baichuan-13b")
    parser.add_argument("--seed", type=int, default=cs.SEED)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_a8_admission: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    cfg = PRESETS[args.preset]
    params = random_quantized_params(cfg, torch.Generator(device=dev).manual_seed(cs.SEED),
                                     quantize_lm_head=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n, bucket = cs.ADMISSION_PROMPT, 1024
    toks = torch.zeros(1, bucket, dtype=torch.long, device=dev)
    toks[0, :n] = torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=dev)
    pos = torch.arange(bucket, device=dev)[None]
    last = torch.tensor([n - 1], device=dev)

    def admit(c, use, a8):
        with torch.inference_mode():
            caches = init_caches(c, 1, bucket, dev, torch.int8)
            logits, _ = forward_inner(params, c, toks, pos, caches, 0, use_kernels=use, a8=a8,
                                      last_pos=last)
        return logits[:, -1]

    def rel(got, ref):
        return (got - ref).abs().max().item() / ref.abs().max().item()

    cfgs = {"as is": cfg}
    if cfg.alibi:
        cfgs["rope in place of ALiBi"] = dataclasses.replace(cfg, alibi=False)
    for tag, c in cfgs.items():
        for a8 in (True, False):
            print(f"{args.preset} {tag}, {'W8A8' if a8 else 'W8A16'} admission: kernel path "
                  f"against plain path {rel(admit(c, True, a8), admit(c, False, a8)):.4e}")
    exact = attention.attention_reference
    def rounded_attention(q, k, v, mask, scale, slopes=None):
        return fa.flash_attention_ref(q, k, v, True, scale, cfg.sliding_window, slopes)

    attention.attention_reference = rounded_attention
    try:
        rounded = admit(cfg, False, True)
    finally:
        attention.attention_reference = exact
    print(f"{args.preset} as is, W8A8 admission: kernel path against a plain path with the "
          f"flash kernel's rounding {rel(admit(cfg, True, True), rounded):.4e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
