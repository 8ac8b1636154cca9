"""Fixtures of the benchmark's CPU tests: a checkout-shaped directory that
holds a toy benchmark, made only of new data files beside the real code
(the way a later change adds a configuration, a mix and a cell)."""

import json
import os
import sys
from pathlib import Path

import pytest

SERVEBENCH = Path(__file__).resolve().parent.parent
ROOT = SERVEBENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TOY = {
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 256,
    "max_position_embeddings": 512, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "model_type": "mistral", "sliding_window": 48,
    "quantize": {"bits": 8, "group_size": None, "lm_head": False},
    "engine": {"max_batch": 4, "max_len": 160, "prompt_buckets": [16, 32, 64, 128],
               "decode_window": 4},
}
TOY_MOE = dict(TOY, model_type="mixtral", sliding_window=None, num_local_experts=4,
               num_experts_per_tok=2)
MIXES = {
    "toychat": {"kind": "closed", "clients": 4,
                "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.6, "min": 4, "max": 100},
                "budget": {"dist": "lognormal", "median": 8, "sigma": 0.5, "min": 2, "max": 24}},
    "toyclosed": {"kind": "closed", "clients": 4,
                  "prompt": {"dist": "uniform", "min": 8, "max": 40},
                  "budget": {"dist": "uniform", "min": 4, "max": 16}},
}
CELLS = {
    # the toys' sound runs read mean gaps of 0-0.0006 and mean routing
    # shortfalls under 0.00004 over seeds, the fp8 control 0.008-0.017 and
    # 0.0018-0.0031 (test_servebench_reference.py)
    "toy.chat": ("toy", "toychat", {"warm_in_s": 0.5, "limits": {"mean_logit_gap": 0.003}}),
    "toy-moe.closed": ("toy-moe", "toyclosed", {"warm_in_s": 0.5,
                                                "limits": {"mean_logit_gap": 0.003,
                                                           "mean_route_gap": 0.0005}}),
}
METRIC = {"unit": "ms", "better": "lower", "source": "host_clock"}


def _bench() -> dict:
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {
        "command": real["command"], "paths": real["paths"], "run_seconds": 2,
        "configs": [{"name": n, "source": "toy", "file": f"servebench/configs/{n}.json",
                     "reduced": [], "why": "toy"} for n in ("toy", "toy-moe")],
        "workloads": [{"name": c, "config": cfg, "traffic": mix, "chips": 1, "why": "toy"}
                      for c, (cfg, mix, _) in CELLS.items()],
        "end_to_end": real["end_to_end"],
        "per_layer": real["per_layer"],
    }


def make_toy_root(tmp_path: Path) -> Path:
    """A directory shaped like a checkout: BENCHMARK.json of the toy cells,
    and servebench/ with the real code linked in and toy data files."""
    sb = tmp_path / "servebench"
    sb.mkdir()
    for name in ("client.py", "sizes.py", "metrics", "kernel_classes.json"):
        os.symlink(SERVEBENCH / name, sb / name)
    (sb / "traffic").mkdir()
    os.symlink(SERVEBENCH / "traffic" / "closed.py", sb / "traffic" / "closed.py")
    for name, mix in MIXES.items():
        (sb / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    (sb / "configs").mkdir()
    (sb / "configs" / "toy.json").write_text(json.dumps(TOY))
    (sb / "configs" / "toy-moe.json").write_text(json.dumps(TOY_MOE))
    (sb / "workloads").mkdir()
    bench = _bench()
    for name, (_, _, spec) in CELLS.items():
        spec = dict(spec, why="toy")
        (sb / "workloads" / f"{name}.json").write_text(json.dumps(spec))
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


@pytest.fixture
def toy_root(tmp_path):
    return make_toy_root(tmp_path)
