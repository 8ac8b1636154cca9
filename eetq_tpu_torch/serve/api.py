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

Prompts are token ids: the tokenizer is not ported yet, so a text prompt
is answered with 400.

Design notes: the Engine is single-threaded by construction (one device
stream), so all engine access (admission, stepping, polling) serializes
under one condition variable. The scheduler thread steps the engine while
it has work and sleeps otherwise; request handlers enqueue under the lock
and wait on the condition for their tokens.
"""

from __future__ import annotations

import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from eetq_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class EngineServer:
    """Threaded HTTP server around a `serve.engine.Engine`.

    Usage:
        srv = EngineServer(engine, port=8000)
        srv.start()          # non-blocking; srv.port is the bound port
        ...
        srv.shutdown()

    or `srv.serve_forever()` to block the calling thread.
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8000):
        self.engine = engine
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
                        return self._json(400, {
                            "error": "text prompts need a tokenizer, which the "
                            "server does not have yet; send token ids"
                        })
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
                        uid = outer.engine.add_request(prompt, **kwargs)
                        outer.cond.notify_all()  # wake the scheduler
                except (ValueError, NotImplementedError) as e:  # over max_len, LoRA, ...
                    return self._json(400, {"error": str(e)})
                if not stream:
                    with outer.cond:
                        outer.cond.wait_for(
                            lambda: outer.engine.requests[uid].done
                            or outer._stop
                        )
                        toks = list(outer.engine.requests[uid].out_tokens)
                    return self._json(200, {"uid": uid, "tokens": toks})
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

    def _schedule(self) -> None:
        while True:
            with self.cond:
                self.cond.wait_for(
                    lambda: self._stop or self.engine.has_work
                )
                if self._stop:
                    return
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
        with self.cond:
            self._stop = True
            self.cond.notify_all()
        self._httpd.shutdown()
        if self._sched is not None:
            self._sched.join(timeout=10)
