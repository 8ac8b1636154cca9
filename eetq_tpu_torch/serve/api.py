"""HTTP serving front-end over the continuous-batching Engine.

Port of `eetq_tpu/serve/api.py::EngineServer` around the port's engine: a
dependency-free threaded HTTP server (the standard library's) with
per-token streaming.

Endpoints:
  POST /v1/completions  (and its alias POST /generate)
      {"prompt": [token ids...], "max_new_tokens": N,
       "temperature": 0.0, "top_k": 0, "stream": false,
       "eos_token_id": null, "lora_id": 0}
    -> {"uid": U, "tokens": [...]}            (stream=false)
    -> text/event-stream of `data: {"tokens": [...], "done": bool}`
       events, one per engine step that commits tokens (stream=true).
  GET /health
    -> {"ok": true, "queued": n, "active": m}

Text or token ids in, both out (`eetq_tpu/serve/api.py:21-26`): the prompt
is a list of token ids, or a string where the server holds a tokenizer
(`tokenizer=`, a `serve.tokenizer.Tokenizer` or anything with encode and
decode), which encodes it; then responses carry `"text"` beside the ids
and stream events the text each adds (`_stream_delta`). `detokenize=` is
an ids -> text callable alone. A text prompt to a server without a
tokenizer is answered with 400.

Design notes: the Engine is single-threaded by construction (one device
stream), so all engine access (admission, stepping, polling) serializes
under one condition variable. The scheduler thread steps the engine while
it has work and sleeps otherwise; request handlers enqueue under the lock
and wait on the condition for their tokens.

Over the ranks of a sharded engine (`Engine(model)` of a
`dist.sharding.ShardedModel` in a world of more than one rank), rank 0 runs
this server and every other rank runs `follow(engine)`, which serves no
HTTP. Each rank's engine must see the same requests in the same order
before the same steps (the contract of the sharded engine), so rank 0
records each admission's arguments when a handler adds it (a text prompt
encoded first) and, before each `engine.step()`, broadcasts the admissions
made since the last step with the command "step" over a gloo control group
(`dist.multihost.control_group`, gloo whatever the data backend); the
followers add the same requests, check that their uids are rank 0's, and
step. While idle, rank 0 sends "idle" every `heartbeat_s` seconds, so that
no follower waits past the process group's timeout
(`multihost.DEFAULT_TIMEOUT_S`); `shutdown()` sends "stop", and each
`follow` returns.
"""

from __future__ import annotations

import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch.distributed as dist

from eetq_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# a broadcast's commands to the followers
STEP, IDLE, STOP = "step", "idle", "stop"
HEARTBEAT_S = 30.0


def _over_ranks(engine) -> bool:
    """Whether the engine is a sharded one in a world of more than one rank."""
    return (getattr(engine, "mesh", None) is not None and dist.is_available()
            and dist.is_initialized() and dist.get_world_size() > 1)


def follow(engine) -> dict:
    """A follower rank's loop beside rank 0's `EngineServer` over the same
    sharded engine (module docstring): receive each broadcast, add its
    admissions in order (their uids must be rank 0's), and step on "step";
    return on "stop". Returns {"steps": n, "idle": heartbeats received}."""
    from eetq_tpu_torch.dist.multihost import control_group

    if not _over_ranks(engine) or dist.get_rank() == 0:
        raise ValueError("follow(engine) runs on the ranks other than 0 of a sharded engine")
    group, seen = control_group(), {STEP: 0, IDLE: 0}
    while True:
        msg = [None]
        dist.broadcast_object_list(msg, src=0, group=group)
        cmd, admissions = msg[0]
        for uid, prompt, kwargs in admissions:
            got = engine.add_request(prompt, **kwargs)
            if got != uid:
                raise RuntimeError(f"rank {dist.get_rank()}: admission {got}, rank 0's {uid}")
        if cmd == STOP:
            return {"steps": seen[STEP], "idle": seen[IDLE]}
        seen[cmd] += 1
        if cmd == STEP:
            engine.step()


def _stream_delta(prev_text: str, text: str, done: bool):
    """The text a stream event adds (`eetq_tpu/serve/api.py::_stream_delta`):
    `text` is the decode of every token so far, `prev_text` what the
    earlier events sent. Before the end, trailing U+FFFD characters (a
    UTF-8 sequence cut by the event's last token) are held back until the
    next event completes them. Returns (delta, restart_at, new prev_text):
    restart_at is None, or the length of the common prefix where the
    decoded text no longer extends what was sent (the client rewinds to
    it)."""
    if not done:
        text = text.rstrip("\ufffd")
    if text.startswith(prev_text):
        return text[len(prev_text):], None, text
    common = 0
    for a, b in zip(prev_text, text):
        if a != b:
            break
        common += 1
    return text[common:], common, text


class EngineServer:
    """Threaded HTTP server around a `serve.engine.Engine`.

    Usage:
        srv = EngineServer(engine, port=8000)
        srv.start()          # non-blocking; srv.port is the bound port
        ...
        srv.shutdown()

    or `srv.serve_forever()` to block the calling thread.
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8000, detokenize=None,
                 tokenizer=None, heartbeat_s: float = HEARTBEAT_S):
        self.engine = engine
        self.tokenizer = tokenizer
        # over ranks: the control group, and the admissions not yet broadcast
        self._ranks = _over_ranks(engine)
        if self._ranks:
            from eetq_tpu_torch.dist.multihost import control_group

            if dist.get_rank() != 0:
                raise ValueError("EngineServer runs on rank 0 of a sharded engine; the other "
                                 "ranks call serve.api.follow(engine)")
            self._group = control_group()
        self.heartbeat_s = float(heartbeat_s)
        self._pending: list = []
        if detokenize is None and tokenizer is not None:
            detokenize = tokenizer.decode
        self.detokenize = detokenize
        # One lock for every engine touch; handlers wait on the condition
        # and the scheduler notifies after each step commits tokens.
        self.cond = threading.Condition()
        self._stop = False
        self._sched: threading.Thread | None = None
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route through our logger
                log.debug("http: " + fmt % args)

            def _json(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path != "/health":
                    return self._json(404, {"error": "not found"})
                with outer.cond:
                    eng = outer.engine
                    active = sum(r is not None for r in eng.slot_req)
                    self._json(200, {"ok": True, "queued": len(eng.queue),
                                     "active": active})

            def do_POST(self):
                if self.path not in ("/v1/completions", "/generate"):
                    return self._json(404, {"error": "not found"})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    prompt = req["prompt"]
                    if isinstance(prompt, str):
                        if outer.tokenizer is None:
                            return self._json(400, {
                                "error": "text prompts need a server-side tokenizer "
                                "(EngineServer(tokenizer=...)); send token ids"
                            })
                        prompt = outer.tokenizer.encode(prompt)
                    kwargs = dict(
                        max_new_tokens=int(req.get("max_new_tokens", 16)),
                        temperature=float(req.get("temperature", 0.0)),
                        top_k=int(req.get("top_k", 0)),
                        eos_token_id=req.get("eos_token_id"),
                        lora_id=int(req.get("lora_id", 0)),
                    )
                except (KeyError, TypeError, ValueError) as e:
                    return self._json(400, {"error": f"bad request: {e}"})
                stream = bool(req.get("stream", False))
                try:
                    with outer.cond:
                        uid = outer._admit(prompt, kwargs)
                        outer.cond.notify_all()  # wake the scheduler
                except ValueError as e:  # over max_len, bad top_k or lora_id, ...
                    return self._json(400, {"error": str(e)})
                if not stream:
                    with outer.cond:
                        outer.cond.wait_for(
                            lambda: outer.engine.requests[uid].done
                            or outer._stop
                        )
                        toks = list(outer.engine.requests[uid].out_tokens)
                    out = {"uid": uid, "tokens": toks}
                    if outer.detokenize is not None:
                        out["text"] = outer.detokenize(toks)
                    return self._json(200, out)
                # SSE streaming: one event per committed token batch
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(data: bytes) -> None:
                    self.wfile.write(f"{len(data):x}\r\n".encode())
                    self.wfile.write(data + b"\r\n")
                    self.wfile.flush()

                done = False
                all_toks: list[int] = []
                prev_text = ""
                while not done:
                    with outer.cond:
                        outer.cond.wait_for(
                            lambda: outer.engine.requests[uid].polled
                            < len(outer.engine.requests[uid].out_tokens)
                            or outer.engine.requests[uid].done
                            or outer._stop
                        )
                        if outer._stop:
                            break
                        toks, done = outer.engine.poll(uid)
                    ev = {"tokens": toks, "done": done}
                    if outer.detokenize is not None:
                        # the whole sequence decoded again and its new text
                        # sent: a character may span the tokens of two events
                        all_toks.extend(toks)
                        delta, restart, prev_text = _stream_delta(
                            prev_text, outer.detokenize(all_toks), done)
                        ev["text"] = delta
                        if restart is not None:
                            ev["restart_at"] = restart
                    chunk(b"data: " + json.dumps(ev).encode() + b"\n\n")
                chunk(b"")  # terminating chunk

        class _Server(ThreadingHTTPServer):
            def handle_error(self, request, client_address):
                # a client hanging up mid-stream (SSE consumers often do)
                # is normal operation, not a server error worth a traceback
                exc = sys.exc_info()[1]  # sys.exception() needs 3.12+
                if isinstance(exc, (ConnectionResetError, BrokenPipeError)):
                    return
                super().handle_error(request, client_address)

        self._httpd = _Server((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]

    # ---- scheduler ----

    def _admit(self, prompt, kwargs: dict) -> int:
        """Add a request to the engine (under the lock); over ranks, record
        its arguments for the next broadcast."""
        uid = self.engine.add_request(prompt, **kwargs)
        if self._ranks:
            self._pending.append((uid, list(self.engine.requests[uid].prompt), dict(kwargs)))
        return uid

    def _broadcast(self, cmd: str) -> None:
        """Send the followers `cmd` and the admissions since the last send."""
        dist.broadcast_object_list([(cmd, self._pending)], src=0, group=self._group)
        self._pending = []

    def _schedule(self) -> None:
        while True:
            with self.cond:
                self.cond.wait_for(
                    lambda: self._stop or self.engine.has_work,
                    timeout=self.heartbeat_s if self._ranks else None,
                )
                if self._ranks:
                    self._broadcast(STOP if self._stop
                                    else STEP if self.engine.has_work else IDLE)
                if self._stop:
                    return
                if not self.engine.has_work:  # a heartbeat
                    continue
                self.engine.step()  # commits tokens -> wake pollers
                self.cond.notify_all()

    # ---- lifecycle ----

    def start(self) -> None:
        """Start the scheduler and HTTP threads; returns immediately."""
        self._sched = threading.Thread(
            target=self._schedule, name="eetq-engine-sched", daemon=True
        )
        self._sched.start()
        threading.Thread(
            target=self._httpd.serve_forever, name="eetq-http", daemon=True
        ).start()
        log.info("serving on http://%s:%d", self.host, self.port)

    def serve_forever(self) -> None:
        self.start()
        try:
            self._sched.join()
        except KeyboardInterrupt:
            self.shutdown()

    def shutdown(self) -> None:
        """Stop serving; over ranks the followers' `follow` returns."""
        with self.cond:
            self._stop = True
            self.cond.notify_all()
        self._httpd.shutdown()
        if self._sched is not None:
            self._sched.join(timeout=10 + (self.heartbeat_s if self._ranks else 0))
