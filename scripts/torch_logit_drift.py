#!/usr/bin/env python3
"""Where a preset's kernel path parts from its plain path (the PyTorch port
on a CUDA card): prefill logits at full width and depth, random W8A16
weights from a seed as `chip_smoke.py`'s families phase builds them.

Run from the repository root, on a machine with an H100:

    python3 scripts/torch_logit_drift.py [--preset gemma-7b] [--prompt 1024] [--seed 0]

A b=1 prompt of seeded tokens, the last position's logits. Printed, as the
error over the largest logit: the kernel path against the plain path
(`chip_smoke.py`'s prefill check); against a plain path whose prefill
attention rounds as the flash kernel does (q * scale and p in bf16:
`kernels/flash_attention.py::flash_attention_ref`); with only the attention
on the kernel, and with only the linears on the kernel. Then, layer by
layer, the hidden state's difference between the two paths (max over max,
and the ratio of norms), carried from the embedding, beside one layer's own
(the kernel layer and the plain layer on the plain path's input). For a
preset with unit-offset norms (gemma), the first line again with the
stored norms at 0, so that every norm's gain is 1 as in the other presets'
random models. It tells a kernel's defect (a layer's own difference far
above a few bf16 ulps) from the model's amplification of ulp-level
differences (own differences at ulp level, carried ones growing).
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    from eetq_tpu_torch.models import transformer as tr
    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.init import random_quantized_params
    from eetq_tpu_torch.modules import attention
    from eetq_tpu_torch.modules.attention import init_kv_cache
    from eetq_tpu_torch.ops.rope import cos_sin_cache

    fa = importlib.import_module("eetq_tpu_torch.kernels.flash_attention")
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--preset", default="gemma-7b")
    parser.add_argument("--prompt", type=int, default=1024)
    parser.add_argument("--seed", type=int, default=cs.SEED)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_logit_drift: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    cfg = PRESETS[args.preset]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = random_quantized_params(cfg, gen, quantize_lm_head=True)
    p = args.prompt
    toks = torch.randint(0, cfg.vocab_size, (1, p), generator=gen, device=dev)
    pos = torch.arange(p, device=dev)[None]

    def prefill(use):
        with torch.inference_mode():
            caches = tr.init_caches(cfg, 1, p, dev)
            logits, _ = tr.forward_inner(params, cfg, toks, pos, caches, 0, use_kernels=use,
                                         last_only=True)
        return logits[:, -1]

    def rel(got, ref):
        return (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()

    def norm_rel(got, ref):
        return ((got.float() - ref.float()).norm() / ref.float().norm()).item()

    plain = prefill(False)
    print(f"{args.preset} p={p} prefill: kernel path against plain path "
          f"{rel(prefill(True), plain):.4e}")
    exact = attention.attention_reference

    def rounded_attention(q, k, v, mask, scale, slopes=None):
        return fa.flash_attention_ref(q, k, v, True, scale, cfg.sliding_window, slopes)

    attention.attention_reference = rounded_attention
    try:
        rounded = prefill(False)
    finally:
        attention.attention_reference = exact
    print(f"  against a plain path with the flash kernel's rounding "
          f"{rel(prefill(True), rounded):.4e}; that plain path against the exact one "
          f"{rel(rounded, plain):.4e}")
    lin, att = tr.linear_apply, tr.attention
    tr.linear_apply = lambda *a, **kw: lin(*a, **dict(kw, use_kernel=False))
    try:
        only_attn = prefill(True)
    finally:
        tr.linear_apply = lin
    tr.attention = lambda *a, **kw: att(*a, **dict(kw, use_kernels=False))
    try:
        only_lin = prefill(True)
    finally:
        tr.attention = att
    print(f"  only the attention on the kernel {rel(only_attn, plain):.4e}; only the linears "
          f"{rel(only_lin, plain):.4e}")

    # layer by layer: carried and own differences of the hidden state
    with torch.inference_mode():
        x = params.embed[toks].to(torch.bfloat16)
        if cfg.embedding_multiplier is not None:
            x = (x.float() * cfg.embedding_multiplier).to(x.dtype)
        cos_sin = cos_sin_cache(cfg.max_position, cfg.rot_dim, base=cfg.rope_theta, device=dev)
        xk = xp = x
        for i, layer in enumerate(params.layers):
            step = [tr.decoder_layer(layer, cfg, h, pos, cos_sin,
                                     init_kv_cache(1, p, cfg.num_kv_heads, cfg.head_dim, dev),
                                     0, use_kernels=use)[0]
                    for h, use in ((xk, True), (xp, False), (xp, True))]
            xk, xp, own = step
            print(f"  layer {i:2d}: carried {rel(xk, xp):.3e} (norms {norm_rel(xk, xp):.3e}), "
                  f"own {rel(own, xp):.3e} (norms {norm_rel(own, xp):.3e}), "
                  f"max |h| {xp.float().abs().max().item():.1f}")
    if cfg.rmsnorm_unit_offset:
        for layer in params.layers:
            layer.input_norm.zero_()
            layer.post_norm.zero_()
        params.final_norm.zero_()
        print(f"  stored norms at 0 (gain 1): kernel path against plain path "
              f"{rel(prefill(True), prefill(False)):.4e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
