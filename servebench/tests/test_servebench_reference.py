"""The plain reference against the port at a toy size on the CPU: its
quantizer equals the port's, its logits follow the port's forward, and the
check reads small gaps for the engine's greedy tokens and large ones for
the fp8 control."""

import random

import pytest
import torch

from conftest import TOY, TOY_MOE
from eetq_tpu_torch.models.transformer import forward_inner
from eetq_tpu_torch.quant.quantizer import symmetric_quantize
from eetq_tpu_torch.serve.engine import Engine
from servebench import deploy, weights
from servebench.reference import check
from servebench.reference.model import Reference, quantize

CPU = torch.device("cpu")


def test_quantizer_is_eetqs():
    w = weights.layer_weights(TOY_MOE, 2**35, 1, CPU)
    for name in ("qkv", "o"):
        q, s = quantize(w[name])
        pq, ps = symmetric_quantize(w[name])
        assert torch.equal(q, pq) and torch.equal(s, ps)
    q, s = quantize(w["gateup"])  # a bank: per expert and channel
    for e in range(TOY_MOE["num_local_experts"]):
        pq, ps = symmetric_quantize(w["gateup"][e])
        assert torch.equal(q[e], pq) and torch.equal(s[e], ps)


def test_weights_are_the_seeds():
    a = weights.layer_weights(TOY, 7, 1, CPU)
    b = weights.layer_weights(TOY, 7, 1, CPU)
    c = weights.layer_weights(TOY, 8, 1, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["qkv"], c["qkv"])
    assert weights.part_seed(2**62 + 1, 3, "o") != weights.part_seed(2**62 + 2, 3, "o")


@pytest.mark.parametrize("hf", [TOY, TOY_MOE], ids=["dense", "moe"])
def test_reference_follows_the_ports_forward(hf):
    seed = 11
    params = deploy.build_params(hf, seed, CPU)
    cfg = deploy.config_of(hf)
    toks = torch.randint(0, hf["vocab_size"], (1, 80), generator=torch.Generator().manual_seed(3))
    got, _ = forward_inner(params, cfg, toks, torch.arange(80)[None], None, 0, use_kernels=False)
    ref = Reference(hf, seed, CPU).logits([toks[0]], [torch.arange(80)])[0]
    err = (got[0] - ref).abs().max(dim=-1).values
    scale = ref.abs().max()
    if hf is TOY:
        assert err.max() < 0.03 * scale  # bf16 activations against f32
    else:
        # a near tie of the toy router flips an expert between bf16 and
        # f32 now and then; elsewhere the two agree as the dense model does
        assert err.median() < 0.03 * scale


def test_engine_gaps_against_the_control():
    """Sound greedy tokens read widest gaps under 0.05 and means under 0.002
    at every seed; the fp8 control reads 0.15 and more, and means above
    0.005 (the toy cells' limit lies between)."""
    for seed in (1, 2, 3):
        params = deploy.build_params(TOY, seed, CPU)
        eng = Engine(params, deploy.config_of(TOY), **TOY["engine"])
        rng = random.Random(seed)
        prompts = [[rng.randrange(256) for _ in range(rng.randrange(8, 60))] for _ in range(8)]
        outs = eng.generate_all(prompts, 24)
        recs = [{"ok": True, "prompt": p, "tokens": o, "n": len(o), "prompt_len": len(p)}
                for p, o in zip(prompts, outs)]
        got = check.logit_gaps(TOY, seed, CPU, recs, control=True)
        assert got["tokens"] == 8 * 24
        assert got["program"]["max"] < 0.05 and got["mean_logit_gap"] < 0.002
        assert got["control"]["max"] > 0.15 and got["control_gap"] > 0.005


def test_sample_holds_the_longest():
    recs = [{"ok": True, "n": n, "prompt_len": 10} for n in (5, 50, 7, 9, 200, 30)]
    recs.append({"ok": False, "n": 500, "prompt_len": 10})
    s = check.sample(recs, seed=4)
    assert s[0]["n"] == 200 and all(r["ok"] for r in s)
    assert check.sample(recs, seed=4) == s


def test_moe_engine_gaps_with_its_routing_replayed():
    """The toy MoE engine's greedy tokens, judged with the experts its
    router chose replayed: gaps and routing shortfalls as small as the dense
    toy's; the fp8 control's far larger."""
    for seed in (1, 2):
        log = deploy.RoutingLog()
        log.install()
        params = deploy.build_params(TOY_MOE, seed, CPU)
        eng = deploy.BenchEngine(params, deploy.config_of(TOY_MOE), routing=log,
                                 **TOY_MOE["engine"])
        rng = random.Random(seed)
        prompts = [[rng.randrange(256) for _ in range(rng.randrange(8, 60))] for _ in range(8)]
        uids = [eng.add_request(p, 24) for p in prompts]
        eng.run()
        recs = [{"ok": True, "prompt": p, "tokens": eng.result(u), "n": 24, "prompt_len": len(p)}
                for p, u in zip(prompts, uids)]
        routes = [log.routes(u, len(p) + 23) for p, u in zip(prompts, uids)]
        assert all(r is not None for r in routes)
        got = check.logit_gaps(TOY_MOE, seed, CPU, recs, routes, control=True)
        assert got["program"]["max"] < 0.05 and got["program"]["route_max"] < 0.05
        assert got["mean_logit_gap"] < 0.002 and got["mean_route_gap"] < 0.0002
        assert got["control_gap"] > 0.005 and got["control_route_gap"] > 0.001
