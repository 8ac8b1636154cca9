"""The served tokens judged against the reference, after the window.

A sample of the window's finished requests, drawn from the seed and always
holding the one that served the most tokens, is run through the reference
once, each prompt followed by the tokens it was served. At every served
position the reference's best logit is compared with its logit of the
served token: the gap is 0 where the program chose the reference's best,
and small where it chose a near tie. The mean gap over the sample's served
tokens is the number compared (`mean_logit_gap`); the widest is printed
beside it. The widest gap does not separate the program from the control
by the factor of three a limit needs (PERF.md §2: it is set by the few near
ties either side flips), while the mean does. Greedy tokens only: every
request of the benchmark is greedy.

On an MoE model the reference replays the experts the program's router
chose for each token (`deploy.RoutingLog`): with random weights a router's
second and third logits lie within rounding of each other at about one
(token, layer) in a hundred, and a flipped choice moves the token's logits
by far more than any precision does, so a reference with routing of its
own parts from any program at a third of the served tokens. The routing
the replay skips is checked by itself (`mean_route_gap`): a chosen
expert's router logit lies within rounding of the reference's own top k.

The control (`control_gap`, `control_route_gap`, their means): the reference in the
next precision below the deployment's (`Reference(precision="fp8")`) put
in the program's place over the same prompts and tokens: at each position
the token it puts first, and the f32 reference's gap to that token (the f32
reference replaying the control's routing). The benchmark's own runs do
not compute it.
"""

from __future__ import annotations

import random

import torch

from servebench.reference.model import Reference

SAMPLE_TOKENS = 400  # served tokens the sample holds at least, where the window has them
SAMPLE_REQUESTS = 4  # and requests at least
SAMPLE_MAX_TOKENS = 24000  # prompt and served tokens the sample holds at most


def sample(records: list[dict], seed: int) -> list[dict]:
    """The longest finished window request, then others in an order drawn
    from the seed, until SAMPLE_REQUESTS requests and SAMPLE_TOKENS served
    tokens (or SAMPLE_MAX_TOKENS tokens in all) are in."""
    done = [r for r in records if r["ok"]]
    if not done:
        return []
    longest = max(done, key=lambda r: (r["n"], r["prompt_len"]))
    rest = [r for r in done if r is not longest]
    random.Random(f"{seed}:sample").shuffle(rest)
    out, served, total = [longest], longest["n"], longest["n"] + longest["prompt_len"]
    for r in rest:
        if served >= SAMPLE_TOKENS and len(out) >= SAMPLE_REQUESTS:
            break
        size = r["n"] + r["prompt_len"]
        if total + size > SAMPLE_MAX_TOKENS:
            continue
        out.append(r)
        served += r["n"]
        total += size
    return out


def _inputs(recs: list[dict]):
    seqs, at, served = [], [], []
    for r in recs:
        p, toks = r["prompt"], r["tokens"]
        seqs.append(torch.tensor(p + toks[:-1], dtype=torch.long))
        at.append(torch.arange(len(p) - 1, len(p) + len(toks) - 1))
        served.append(torch.tensor(toks, dtype=torch.long))
    return seqs, at, served


def logit_gaps(cfg: dict, seed: int, device, recs: list[dict], routes: list | None = None,
               control: bool = False) -> dict:
    """{"mean_logit_gap", "tokens", "requests", "program"} of the program's
    served tokens against the f32 reference, and on an MoE model
    "mean_route_gap": the reference replays the experts the program chose
    (`routes`, [layers, T, k] a request), and that number is the mean, over
    every (layer, position), of the shortfall of the weaker chosen expert's
    router logit below the reference's own k-th best (0 where the choice is
    the reference's). "program": the gaps' summary, the widest route gap
    with it. With control=True also "control_gap" and "control_route_gap":
    the same two numbers of the fp8 control put in the program's place (its
    first choice at each position, its own routing replayed), and "control",
    its summary."""
    seqs, at, served = _inputs(recs)
    ref_model = Reference(cfg, seed, device)
    ref = ref_model.logits(seqs, at, routes)
    gaps = _gaps(ref, served)
    out = {"mean_logit_gap": float(gaps.mean()), "tokens": len(gaps), "requests": len(recs),
           "program": summary(gaps)}
    if routes is not None:
        out["mean_route_gap"] = ref_model.route_gap_mean
        out["program"]["route_max"] = ref_model.route_gap
    if control:
        ctl_model = Reference(cfg, seed, device, precision="fp8")
        ctl = ctl_model.logits(seqs, at)
        ctl_routes = None if routes is None else ctl_model.chosen
        if ctl_routes is not None:  # the reference follows the control's routing
            ref_model = Reference(cfg, seed, device)
            ref = ref_model.logits(seqs, at, ctl_routes)
        cgaps = _gaps(ref, [lc.argmax(dim=-1) for lc in ctl])
        out["control"] = summary(cgaps)
        out["control_gap"] = out["control"]["mean"]
        if ctl_routes is not None:
            out["control_route_gap"] = ref_model.route_gap_mean
            out["control"]["route_max"] = ref_model.route_gap
    return out


def _gaps(ref: list[torch.Tensor], picks: list[torch.Tensor]) -> torch.Tensor:
    """The reference's best logit less its logit of each picked token, over
    every position of every sequence."""
    out = []
    for lg, toks in zip(ref, picks):
        toks = toks.to(lg.device)
        out.append(lg.max(dim=-1).values - lg.gather(1, toks[:, None])[:, 0])
    return torch.cat(out).float().cpu()


def summary(gaps: torch.Tensor) -> dict:
    """The gaps' widest, 99th percentile and mean, and the shares of
    positions off the reference's first choice and more than 0.1 below it."""
    return {"max": float(gaps.max()), "p99": float(torch.quantile(gaps, 0.99)),
            "mean": float(gaps.mean()), "off": float((gaps > 0).float().mean()),
            "off_0.1": float((gaps > 0.1).float().mean())}
