"""The port's HTTP front end over its engine (toy preset, W8A8 prefill and
int8 KV), mirroring `tests/test_api.py`: `/health`, non-streamed and
streamed completions on both routes equal to the engine's own greedy
output, concurrent requests sharing the batch, and 400s for a text prompt
without a tokenizer and for invalid requests."""

import http.client
import json
import threading

import pytest
import torch

from eetq_tpu_torch.models.config import PRESETS
from eetq_tpu_torch.models.init import quantize_params, random_dense_params
from eetq_tpu_torch.serve.api import EngineServer
from eetq_tpu_torch.serve.engine import Engine

CFG = PRESETS["toy"]
KW = dict(max_batch=2, max_len=64, prompt_buckets=(8,), a8_prefill=True, kv_dtype=torch.int8)


@pytest.fixture(scope="module")
def params():
    gen = torch.Generator().manual_seed(0)
    return quantize_params(random_dense_params(CFG, gen), quantize_lm_head=True)


def _greedy(params, prompt, n):
    eng = Engine(params, CFG, **KW)
    return eng.generate_all([prompt], n)[0]


def _post(conn, path, body):
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    return conn.getresponse()


def _events(body: bytes) -> list[dict]:
    return [json.loads(line[len(b"data: "):]) for line in body.split(b"\n\n")
            if line.startswith(b"data: ")]


@pytest.fixture
def server(params):
    srv = EngineServer(Engine(params, CFG, **KW), port=0)  # an OS-assigned port
    srv.start()
    yield srv
    srv.shutdown()


def test_generate_stream_and_health(params, server):
    prompt = [3, 17, 42, 9]
    ref = _greedy(params, prompt, 8)
    conn = http.client.HTTPConnection(server.host, server.port, timeout=300)
    for path in ("/generate", "/v1/completions"):
        r = _post(conn, path, {"prompt": prompt, "max_new_tokens": 8})
        assert r.status == 200
        assert json.loads(r.read())["tokens"] == ref
    r = _post(conn, "/generate", {"prompt": prompt, "max_new_tokens": 8, "stream": True})
    assert r.status == 200 and r.getheader("Content-Type") == "text/event-stream"
    events = _events(r.read())
    assert [t for ev in events for t in ev["tokens"]] == ref
    assert events[-1]["done"] and not any(ev["done"] for ev in events[:-1])
    conn.request("GET", "/health")
    r = conn.getresponse()
    health = json.loads(r.read())
    assert r.status == 200 and health == {"ok": True, "queued": 0, "active": 0}


def test_bad_requests_answer_400(server):
    conn = http.client.HTTPConnection(server.host, server.port, timeout=300)
    r = _post(conn, "/generate", {"prompt": "hello", "max_new_tokens": 4})
    assert r.status == 400 and "tokenizer" in json.loads(r.read())["error"]
    r = _post(conn, "/generate", {"prompt": [1, 2], "max_new_tokens": 10_000})
    assert r.status == 400 and "exceeds" in json.loads(r.read())["error"]
    r = _post(conn, "/generate", {"max_new_tokens": 4})
    assert r.status == 400 and "bad request" in json.loads(r.read())["error"]
    r = _post(conn, "/generate", {"prompt": [1, 2], "max_new_tokens": 4, "lora_id": 1})
    assert r.status == 400 and "LoRA" in json.loads(r.read())["error"]
    r = _post(conn, "/nope", {"prompt": [1]})
    assert r.status == 404 and json.loads(r.read()) == {"error": "not found"}


def test_concurrent_requests_batch(params, server):
    prompts = [[3, 17, 42], [5, 6, 7, 8], [1, 2], [99, 42, 7]]
    budgets = [6, 4, 7, 5]
    results = {}

    def worker(i):
        conn = http.client.HTTPConnection(server.host, server.port, timeout=300)
        r = _post(conn, "/generate", {"prompt": prompts[i], "max_new_tokens": budgets[i],
                                      "stream": i % 2 == 0})
        body = r.read()
        results[i] = ([t for ev in _events(body) for t in ev["tokens"]] if i % 2 == 0
                      else json.loads(body)["tokens"])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    for i in range(4):
        assert results[i] == _greedy(params, prompts[i], budgets[i])
