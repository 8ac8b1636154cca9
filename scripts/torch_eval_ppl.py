"""ΔPPL of the PyTorch port: a dense checkpoint against its W8A16 copy.

Port of `scripts/eval_ppl.py` (BASELINE.md: WikiText-2 ΔPPL <= 0.1 against
fp16). Loads a local dense HF checkpoint directory with the port's
`AutoEETQForCausalLM.from_pretrained`, quantizes a copy (`eet_quantize`,
lm_head dense, as `quantize()` leaves it), and prints both perplexities and
their difference, on the card unless `--device` says otherwise.

Usage:
  python scripts/torch_eval_ppl.py --model DIR [--tokens tokens.npy]
      [--window 2048] [--batch 1] [--bits 8] [--group-size G] [--device cuda]

--tokens: a .npy array of token ids (e.g. WikiText-2's test split tokenized
  with the model's tokenizer). Nothing is downloaded: without it a seeded
  synthetic stream of 16 windows is used, which checks the plumbing only and
  says nothing of accuracy.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True, help="a local dense HF checkpoint directory")
    ap.add_argument("--tokens", default=None, help=".npy token ids")
    ap.add_argument("--window", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--group-size", type=int, default=None)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()

    from eetq_tpu_torch.models.auto import AutoEETQForCausalLM
    from eetq_tpu_torch.serve.eval import delta_ppl
    from eetq_tpu_torch.surgery.quantize import eet_quantize

    model = AutoEETQForCausalLM.from_pretrained(args.model, device=args.device)
    cfg, dense = model.cfg, model.params
    quant = eet_quantize(dense, bits=args.bits, group_size=args.group_size)
    if args.tokens:
        ids = np.load(args.tokens).astype(np.int64)
    else:
        print("WARNING: no --tokens; a synthetic stream (a plumbing check only)", file=sys.stderr)
        ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=16 * args.window)
    r = delta_ppl(dense, quant, cfg, ids, window=args.window, batch_size=args.batch)
    print(f"dense PPL:  {r['ppl_dense']:.4f}")
    print(f"quant PPL:  {r['ppl_quant']:.4f}  (bits={args.bits}, group_size={args.group_size})")
    print(f"delta PPL:  {r['delta_ppl']:+.4f}")
    target = 0.1
    print(f"BASELINE target delta <= {target}: {'PASS' if r['delta_ppl'] <= target else 'FAIL'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
