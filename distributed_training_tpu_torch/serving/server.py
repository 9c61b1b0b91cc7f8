"""Serving HTTP server: a stdlib generate endpoint over the engine (port).

The port of ``distributed_training_tpu/serving/server.py``'s core:

- ``POST /generate`` — JSON ``{"prompt_ids": [...]}`` or (byte-vocab
  models) ``{"text": "..."}``, plus ``max_new_tokens``; blocks until the
  request drains through the continuous-batching engine and returns
  ``{"tokens", "text"?, "ttft_s", "latency_s"}``.
- ``POST /generate`` with ``"stream": true`` — chunked transfer
  encoding: one JSON line per token (``{"token": N}``) the moment the
  engine samples it, then a final ``{"done": true, "tokens", ...}``.
- ``GET /healthz`` — 200 with queue/slot stats while the engine thread
  is alive (``status`` "ok", or "draining" during a drain), 503 once it
  died.

Threading model: HTTP handlers never touch the engine. They append to a
mailbox; the single engine thread admits mailbox requests, steps the
engine and signals completion, so the engine stays single-threaded and
a slow client cannot stall decode. ``swap_weights``, ``drain`` and
``resume_admission`` are control commands that the engine thread runs
between steps; while the engine drains, ``POST /generate`` answers 503
with a ``Retry-After`` header.

What waits (ROADMAP.md queue A 'Server: metrics, debug, load shedding
and incidents', and 'Server: main and build_server'): ``GET /metrics``
and ``/debug/requests`` answer 501; the metrics port, queue-depth load
shedding and incident bundles raise ``NotImplementedError``, as do
``build_server``, ``main`` and an engine on a mesh of more than one
process (its requests must reach every rank).
"""

from __future__ import annotations

import http.server
import json
import logging
import queue
import threading
import time

import numpy as np

from distributed_training_tpu_torch import telemetry as tel
from distributed_training_tpu_torch.serving.engine import Request

logger = logging.getLogger(__name__)

OPS_ITEM = ("ROADMAP.md queue A 'Server: metrics, debug, load shedding "
            "and incidents'")
CLI_ITEM = "ROADMAP.md queue A 'Server: main and build_server'"
MESH_ITEM = "ROADMAP.md queue A item 13 'Server: main and build_server'"


class ServingServer:
    """HTTP front + engine thread over a built Engine."""

    def __init__(self, engine, port: int = 0,
                 metrics_port: int | None = None,
                 max_queue_depth: int = 0,
                 retry_after_s: float = 1.0,
                 incident_dir: str | None = None):
        if metrics_port is not None or max_queue_depth or incident_dir:
            raise NotImplementedError(
                f"metrics_port, max_queue_depth and incident_dir wait "
                f"for {OPS_ITEM}")
        mesh = getattr(engine, "mesh", None)
        if mesh is not None and mesh.process_count > 1:
            # Every rank's engine must be given the same submissions:
            # requests taken in on one rank and passed to the others.
            raise NotImplementedError(
                f"serving an engine on a mesh of {mesh.process_count} "
                f"processes over HTTP waits for {MESH_ITEM}")
        self.engine = engine
        self._requested_port = port
        self.port: int | None = None
        self._mailbox: list = []
        self._done: dict[str, dict] = {}
        self._events: dict[str, threading.Event] = {}
        self._streams: dict[str, queue.Queue] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._httpd = None
        self._engine_thread = None
        self._http_thread = None
        self._next_id = 0
        # The engine thread's cause of death, when it died (healthz
        # reports "unhealthy"; waiting clients get the error).
        self.engine_error: str | None = None
        self.leaked_threads = 0
        self.retry_after_s = float(retry_after_s)
        # Control commands (drain, weight swap) run between steps on the
        # engine thread; the public methods enqueue here and wait.
        self._control: list = []

    @property
    def draining(self) -> bool:
        return self.engine.draining

    def _control_call(self, cmd: str, args, timeout: float):
        """Run a command on the engine thread (started server) or inline
        (engine thread not running); either way one thread at a time
        touches the engine. Re-raises the command's exception here."""
        done = threading.Event()
        slot: dict = {}
        with self._lock:
            self._control.append((cmd, args, done, slot))
        t = self._engine_thread
        if t is None or not t.is_alive():
            self._run_control(self.engine)
        elif not done.wait(timeout):
            raise TimeoutError(f"{cmd} command timed out after {timeout}s")
        if "error" in slot:
            raise slot["error"]
        return slot.get("result")

    def swap_weights(self, params, version: str,
                     provenance: dict | None = None,
                     timeout: float = 300.0):
        """Live weight swap through the engine thread
        (``Engine.swap_weights``: every gate, no recapture). Raises the
        engine's refusal; the incumbent weights keep serving."""
        return self._control_call("swap", (params, version, provenance),
                                  timeout)

    def drain(self, deadline_s: float | None = None,
              timeout: float = 300.0) -> dict:
        """Graceful drain through the engine thread: admission stops
        (POST /generate answers 503 with Retry-After, /healthz reports
        "draining"), in-flight work finishes (or persists at the
        deadline), and the engine's report returns.
        ``resume_admission()`` reopens."""
        return self._control_call("drain", deadline_s,
                                  max(timeout, (deadline_s or 0) * 2))

    def resume_admission(self, timeout: float = 60.0) -> None:
        self._control_call("undrain", None, timeout)

    def _run_control(self, eng) -> None:
        """Run the queued control commands; each result or exception
        goes back through its command's slot (a refused swap reaches its
        caller and never ends the engine thread)."""
        with self._lock:
            cmds, self._control = self._control, []
        for cmd, args, done, slot in cmds:
            try:
                if cmd == "swap":
                    slot["result"] = eng.swap_weights(*args)
                elif cmd == "drain":
                    slot["result"] = eng.drain(args)
                else:
                    eng.draining = False
                    slot["result"] = True
            except Exception as e:  # noqa: BLE001 — handed to the caller
                slot["error"] = e
            finally:
                done.set()

    # -- engine thread -------------------------------------------------------

    def _engine_loop(self) -> None:
        try:
            self._engine_loop_inner(self.engine)
        except Exception as e:  # noqa: BLE001 — the engine thread's
            # last act: record why it died and fail every waiting
            # client instead of leaving them blocked until timeout.
            self._on_engine_crash(e)

    def _on_engine_crash(self, exc: Exception) -> None:
        err = f"{type(exc).__name__}: {exc}"
        self.engine_error = err
        logger.exception("serving engine thread died: %s", err)
        tel.event("serving_engine_crash", error=err,
                  launches=self.engine.launch_count,
                  in_flight=self.engine.in_flight,
                  queue_depth=len(self.engine.queue))
        with self._lock:
            events, self._events = self._events, {}
            streams, self._streams = self._streams, {}
            for rid, ev in events.items():
                self._done[rid] = {"id": rid,
                                   "error": f"engine crashed: {err}"}
                ev.set()
        for rid, sq in streams.items():
            sq.put(("done", {"id": rid, "error": f"engine crashed: {err}"}))

    def _engine_loop_inner(self, eng) -> None:
        while not self._stop.is_set():
            self._run_control(eng)
            with self._lock:
                incoming, self._mailbox = self._mailbox, []
            for rid, prompt, n, arrival, session, tenant in incoming:
                with self._lock:
                    stream_q = self._streams.get(rid)
                if stream_q is not None:
                    # Registered before submit, on the engine thread:
                    # the first token cannot race its listener.
                    eng.add_token_listener(
                        rid, lambda tok, done, _q=stream_q:
                        _q.put(("token", tok)))
                try:
                    eng.submit(Request(id=rid, prompt=prompt,
                                       max_new_tokens=n, arrival=arrival,
                                       session=session, tenant=tenant))
                except ValueError as e:
                    # An invalid request answers its caller; it must
                    # never take down the engine thread.
                    eng.remove_token_listener(rid)
                    with self._lock:
                        ev = self._events.pop(rid, None)
                        if ev is not None:
                            self._done[rid] = {"id": rid, "error": str(e)}
                            ev.set()
                        sq = self._streams.pop(rid, None)
                    if sq is not None:
                        sq.put(("done", {"id": rid, "error": str(e)}))
            self._dispatch_completed(eng)
            if eng.idle:
                time.sleep(0.002)
                continue
            eng.step()
            self._dispatch_completed(eng)

    def _dispatch_completed(self, eng) -> None:
        if not eng.completed:
            return
        with self._lock:
            for rec in eng.completed:
                ev = self._events.pop(rec["id"], None)
                if ev is not None:
                    self._done[rec["id"]] = rec
                    ev.set()
                sq = self._streams.pop(rec["id"], None)
                if sq is not None:
                    sq.put(("done", rec))
        eng.completed.clear()

    def _enqueue(self, prompt, max_new_tokens: int, session, tenant,
                 table: dict, waiter) -> str:
        arrival = time.monotonic()
        with self._lock:
            rid = f"http-{self._next_id}"
            self._next_id += 1
            table[rid] = waiter
            self._mailbox.append((rid, np.array(prompt, np.int32),
                                  int(max_new_tokens), arrival, session,
                                  tenant))
        return rid

    def generate(self, prompt: np.ndarray, max_new_tokens: int,
                 timeout: float = 120.0, session: str | None = None,
                 tenant: str = "default") -> dict:
        """Enqueue + wait (the HTTP handler path; also the in-process
        API). ``session``: chat-session key (the engine retains the
        turn's pages under it)."""
        ev = threading.Event()
        rid = self._enqueue(prompt, max_new_tokens, session, tenant,
                            self._events, ev)
        if not ev.wait(timeout):
            with self._lock:
                self._events.pop(rid, None)
                self._done.pop(rid, None)
            raise TimeoutError(f"request {rid} timed out")
        with self._lock:
            return self._done.pop(rid)

    def generate_stream(self, prompt: np.ndarray, max_new_tokens: int,
                        timeout: float = 120.0,
                        session: str | None = None,
                        tenant: str = "default"):
        """Enqueue + yield ``{"token": N}`` per sampled token, then a
        final ``{"done": True, "tokens", "ttft_s", "latency_s"}``."""
        q: queue.Queue = queue.Queue()
        rid = self._enqueue(prompt, max_new_tokens, session, tenant,
                            self._streams, q)
        deadline = time.monotonic() + timeout
        try:
            while True:
                try:
                    kind, val = q.get(
                        timeout=max(0.0, deadline - time.monotonic()))
                except queue.Empty:
                    raise TimeoutError(
                        f"request {rid} timed out mid-stream") from None
                if kind == "token":
                    yield {"token": int(val)}
                    continue
                if "error" in val:
                    raise ValueError(val["error"])
                out = {"done": True, "tokens": val["tokens"],
                       "ttft_s": val["ttft_s"],
                       "latency_s": val["latency_s"]}
                out.update(self._text(val["tokens"]))
                yield out
                return
        finally:
            # Completion, timeout or an abandoned stream: deregister so
            # the engine-side listener stops filling an orphaned queue.
            with self._lock:
                self._streams.pop(rid, None)
            self.engine.remove_token_listener(rid)

    # -- HTTP ----------------------------------------------------------------

    def _text(self, tokens) -> dict:
        if self.engine.model.cfg.vocab_size != 256:
            return {}
        return {"text": bytes(np.array(tokens, np.uint8)).decode(
            "utf-8", errors="replace")}

    def _parse_generate(self, body: dict):
        """Validate a /generate body → (prompt_ids, max_new_tokens,
        session, tenant). Raises ValueError (the 400 path) before
        anything reaches the engine."""
        vocab = self.engine.model.cfg.vocab_size
        if "prompt_ids" in body:
            ids = np.array([int(t) for t in body["prompt_ids"]], np.int32)
        elif "text" in body:
            if vocab != 256:
                raise ValueError(
                    "'text' prompts need a byte-vocab (256) model; "
                    "pass 'prompt_ids'")
            ids = np.frombuffer(body["text"].encode("utf-8"),
                                dtype=np.uint8).astype(np.int32)
        else:
            raise ValueError("body needs 'prompt_ids' or 'text'")
        if ids.size == 0:
            raise ValueError("empty prompt")
        if ids.min() < 0 or ids.max() >= vocab:
            raise ValueError(f"prompt ids must be in [0, {vocab})")
        n = int(body.get("max_new_tokens", 16))
        limit = self.engine.cfg.max_seq_len
        if n < 1 or ids.size + n > limit:
            raise ValueError(
                f"prompt ({ids.size}) + max_new_tokens ({n}) must fit "
                f"max_seq_len ({limit})")
        session = body.get("session")
        if session is not None and not isinstance(session, str):
            raise ValueError("'session' must be a string key")
        tenant = body.get("tenant", "default")
        if not isinstance(tenant, str) or not tenant:
            raise ValueError("'tenant' must be a non-empty string")
        return ids, n, session, tenant

    def _handle_generate(self, body: dict) -> dict:
        ids, n, session, tenant = self._parse_generate(body)
        rec = self.generate(ids, n, session=session, tenant=tenant)
        if "error" in rec:
            raise ValueError(rec["error"])
        out = {"tokens": rec["tokens"], "ttft_s": rec["ttft_s"],
               "latency_s": rec["latency_s"]}
        out.update(self._text(rec["tokens"]))
        return out

    def start(self) -> "ServingServer | None":
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            # Chunked transfer encoding is an HTTP/1.1 construct.
            protocol_version = "HTTP/1.1"

            def _reply(self, code: int, payload: dict,
                       headers: tuple = ()) -> None:
                body = (json.dumps(payload) + "\n").encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                # One request per connection: clients here are one-shot.
                self.send_header("Connection", "close")
                self.close_connection = True
                self.end_headers()
                self.wfile.write(body)

            def _chunk(self, data: bytes) -> None:
                self.wfile.write(f"{len(data):X}\r\n".encode() + data
                                 + b"\r\n")
                self.wfile.flush()

            def _stream_generate(self, body: dict) -> None:
                try:
                    ids, n, session, tenant = server._parse_generate(body)
                except (ValueError, KeyError) as e:
                    self._reply(400, {"error": str(e)})
                    return
                gen = server.generate_stream(ids, n, session=session,
                                             tenant=tenant)
                self.send_response(200)
                self.send_header("Content-Type", "application/jsonl")
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("Connection", "close")
                self.close_connection = True
                self.end_headers()
                try:
                    for item in gen:
                        self._chunk((json.dumps(item) + "\n").encode())
                except (ValueError, TimeoutError) as e:
                    # Headers are gone; the error is the last line.
                    try:
                        self._chunk((json.dumps({"error": str(e)})
                                     + "\n").encode())
                    except OSError:
                        logger.debug("stream client gone before the "
                                     "error line")
                except OSError:
                    logger.debug("stream client disconnected")
                finally:
                    gen.close()
                    try:
                        self.wfile.write(b"0\r\n\r\n")
                    except OSError:
                        logger.debug("stream client gone before the "
                                     "final chunk")

            def _shed(self) -> dict | None:
                """The refusal gate of POST /generate (JAX ``_shed``):
                a 503 with ``Retry-After`` after an engine crash or
                while draining. The queue-depth bound is refused at
                construction (``max_queue_depth``)."""
                if server.engine_error is not None:
                    return {"error": "engine crashed: "
                                     + server.engine_error}
                if server.draining:
                    return {"error": "draining: not admitting new "
                                     "requests"}
                return None

            def do_POST(self):  # noqa: N802 — http.server API
                if self.path.split("?")[0] != "/generate":
                    self._reply(404, {"error": "try POST /generate"})
                    return
                shed = self._shed()
                if shed is not None:
                    self._reply(503, shed, headers=(
                        ("Retry-After",
                         str(max(1, int(server.retry_after_s)))),))
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, KeyError) as e:
                    self._reply(400, {"error": str(e)})
                    return
                if body.get("stream"):
                    self._stream_generate(body)
                    return
                try:
                    self._reply(200, server._handle_generate(body))
                except (ValueError, KeyError) as e:
                    self._reply(400, {"error": str(e)})
                except TimeoutError as e:
                    self._reply(504, {"error": str(e)})

            def do_GET(self):  # noqa: N802 — http.server API
                path = self.path.split("?")[0]
                eng = server.engine
                if path == "/healthz":
                    alive = (server._engine_thread is not None
                             and server._engine_thread.is_alive())
                    ok = server.engine_error is None and alive
                    status = ("unhealthy" if not ok else "draining"
                              if server.draining else "ok")
                    self._reply(200 if ok else 503, {
                        "status": status,
                        "error": server.engine_error,
                        "in_flight": eng.in_flight,
                        "queue_depth": len(eng.queue),
                        "weights_version": eng.weights_version,
                        **eng.cache.occupancy()})
                    return
                if path in ("/metrics", "/debug/requests"):
                    self._reply(501, {"error": f"{path} waits for "
                                      f"{OPS_ITEM}"})
                    return
                self._reply(404, {"error": "try /healthz"})

            def log_message(self, fmt, *args):
                logger.debug("serving http: " + fmt, *args)

        try:
            self._httpd = http.server.ThreadingHTTPServer(
                ("127.0.0.1", self._requested_port), Handler)
        except OSError as e:
            logger.warning("serving endpoint NOT started (port %s): %s",
                           self._requested_port, e)
            return None
        self.port = self._httpd.server_address[1]
        self._engine_thread = threading.Thread(
            target=self._engine_loop, name="serving-engine", daemon=True)
        self._engine_thread.start()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="serving-http",
            daemon=True)
        self._http_thread.start()
        logger.info("serving endpoint on :%d (POST /generate)", self.port)
        return self

    def stop(self) -> None:
        """Stop the HTTP front + engine thread. Joins time out after 5 s
        so a wedged step cannot hang teardown; stragglers are counted in
        ``leaked_threads`` and the ``serving_stop`` event."""
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        leaked = []
        for t in (self._engine_thread, self._http_thread):
            if t is not None:
                t.join(timeout=5)
                if t.is_alive():
                    leaked.append(t.name)
        self.leaked_threads = len(leaked)
        if leaked:
            logger.warning("serving stop leaked %d thread(s): %s",
                           len(leaked), ", ".join(leaked))
        tel.event("serving_stop", leaked_threads=len(leaked),
                  leaked=leaked, engine_error=self.engine_error)
        self._engine_thread = self._http_thread = None


def build_server(*args, **kwargs) -> ServingServer:
    """Artifact + plan → server: needs the export and planner ports."""
    raise NotImplementedError(f"build_server waits for {CLI_ITEM}")


def main(argv=None) -> int:
    raise NotImplementedError(f"the server CLI waits for {CLI_ITEM}")
