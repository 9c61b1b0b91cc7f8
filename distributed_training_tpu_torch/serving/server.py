"""Serving HTTP server: a stdlib generate endpoint over the engine (port
of ``distributed_training_tpu/serving/server.py``).

- ``POST /generate`` — JSON ``{"prompt_ids": [...]}`` or (byte-vocab
  models) ``{"text": "..."}``, plus ``max_new_tokens``; blocks until the
  request drains through the continuous-batching engine and returns
  ``{"tokens", "text"?, "ttft_s", "latency_s"}``.
- ``POST /generate`` with ``"stream": true`` — chunked transfer
  encoding: one JSON line per token (``{"token": N}``) the moment the
  engine samples it, then a final ``{"done": true, "tokens", ...}``.
- ``POST /drain`` and ``POST /resume`` — the drain control over HTTP:
  admission stops and the in-flight work finishes (the reply is the
  engine's drain report), then admission reopens. The JAX server offers
  these only in-process (``drain()``, ``resume_admission()``).
- ``GET /healthz`` — 200 with queue/slot stats while the engine thread
  is alive (``status`` "ok", or "draining" during a drain), 503 once it
  died.
- ``GET /metrics`` — the Prometheus text of a ``MetricsServer`` the
  server always owns, fed by the engine's telemetry records (with
  ``metrics_port`` it also binds its own socket);
  ``GET /debug/requests`` — the in-flight table
  (``debug_requests_snapshot``).

Load shedding: ``POST /generate`` answers 503 with ``Retry-After``
after an engine crash, while draining, and once the queue plus the
mailbox reach ``max_queue_depth``. An engine crash emits
``serving_engine_crash`` and, with ``incident_dir``, leaves an incident
bundle carrying the ``/debug/requests`` snapshot.

Threading model: HTTP handlers never touch the engine. They append to a
mailbox; the single engine thread admits mailbox requests, steps the
engine and signals completion, so the engine stays single-threaded and
a slow client cannot stall decode. Control commands (swap, drain,
resume) run on the engine thread between steps.

On a mesh of more than one process every process runs a server over its
engine. The mesh's first process binds HTTP and ``/metrics`` and owns
the mailbox and the control queue; at the start of each engine-loop
iteration it broadcasts that iteration's submissions, control commands
and stop flag to every process in one collective, so every process
submits, runs the same commands and steps alike (the engine's
scheduler digest turns any divergence into an error on every process).

CLI (the card by default; ``--device cpu`` names the CPU)::

    python -m distributed_training_tpu_torch.serving.server \\
        --artifact model.pt --plan serving_8dev_cpu_decode \\
        --config conf/serving/default.yaml --port 8100 --metrics-port 8101

Under ``torchrun`` (``RANK``/``WORLD_SIZE``/``MASTER_*``) each process
is one rank of the plan's mesh.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import datetime
import http.server
import json
import logging
import os
import queue
import sys
import threading
import time
import types

import numpy as np
import torch.distributed as dist

from distributed_training_tpu_torch import telemetry as tel
from distributed_training_tpu_torch.serving.engine import Request
from distributed_training_tpu_torch.telemetry.metrics_server import (
    PROM_CONTENT_TYPE,
    MetricsServer,
)

logger = logging.getLogger(__name__)

# A collective of a server's mesh that waits this long has hung (a
# process died or raised alone): it fails instead, on every process.
MESH_TIMEOUT_S = 120.0


def debug_requests_snapshot(engine) -> dict:
    """In-flight request table: the ``/debug/requests`` body.

    Engine bookkeeping only (slot table, page tables), no device touch.
    Best effort: the engine thread mutates slots between reads, so a
    sequence finishing mid-render is simply absent. Module-level so
    incident bundles take the same snapshot without HTTP."""
    reqs = []
    for s in list(engine.slots):
        if s is None:
            continue
        try:
            reqs.append({
                "id": s.req.id,
                "tenant": s.req.tenant,
                "group": engine.group_of_slot(s.slot),
                "slot": s.slot,
                "prompt_tokens": s.prompt_len,
                "prefilled": s.prefilled,
                "generated": len(s.generated),
                "pages_held": engine.cache.pages_of(s.req.id),
                "session": s.req.session,
                "weights_versions": [list(p) for p in s.versions]})
        except KeyError:
            continue  # freed between reads
    return {
        "in_flight": len(reqs),
        "queue_depth": len(engine.queue),
        "draining": bool(getattr(engine, "draining", False)),
        "weights": {
            "version": engine.weights_version,
            "provenance": engine.weights_provenance,
            "swaps": dict(engine.swap_stats)},
        "requests": reqs}


def kernel_launches() -> dict:
    """Launches so far, in this process, of the kernels the serving path
    takes, in all and by design: the flash forward (the first chunk of a
    sequential prefill) and paged decode. Each wrapper counts where it
    launches its kernel, so a server on the CPU reads zeros."""
    from distributed_training_tpu_torch.ops import kernel_launches as count

    return count(("flash_fwd", "paged_decode"))


class ServingServer:
    """HTTP front + engine thread over a built Engine."""

    def __init__(self, engine, port: int = 0,
                 metrics_port: int | None = None, telemetry=None,
                 max_queue_depth: int = 0,
                 retry_after_s: float = 1.0,
                 incident_dir: str | None = None):
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
        self._telemetry = telemetry
        # With ``max_queue_depth`` > 0, POST /generate sheds load (503 +
        # Retry-After) once queue + mailbox reach it; with
        # ``incident_dir`` an engine-thread exception leaves a bundle
        # there (kind ``engine_crash``).
        self.max_queue_depth = int(max_queue_depth)
        self.retry_after_s = float(retry_after_s)
        self.incident_dir = incident_dir
        # The engine thread's cause of death, when it died (healthz
        # reports "unhealthy"; new work is shed).
        self.engine_error: str | None = None
        self.leaked_threads = 0
        # Control commands (drain, weight swap) run between steps on the
        # engine thread; the public methods enqueue here and wait. The
        # counter holds the commands this process ran.
        self._control: list = []
        self.control_counts: collections.Counter = collections.Counter()
        # A mesh of more than one process: its first process is the
        # front (HTTP, mailbox, control queue) and broadcasts each
        # iteration's work to the others over the mesh's group.
        mesh = getattr(engine, "mesh", None)
        self._mesh = mesh if mesh is not None and \
            mesh.process_count > 1 else None
        self.is_front = self._mesh is None or \
            self._mesh.process_index == 0
        # A MetricsServer always backs GET /metrics on the serving port
        # (its renderer and observer, no second socket); with
        # ``metrics_port`` the same instance also binds its own endpoint.
        self._metrics_owns_port = metrics_port is not None
        self.metrics = MetricsServer(
            metrics_port if metrics_port is not None else 0,
            telemetry=telemetry)

    def debug_snapshot(self) -> dict:
        """The ``/debug/requests`` body, callable in-process."""
        return debug_requests_snapshot(self.engine)

    @property
    def draining(self) -> bool:
        return self.engine.draining

    def _control_call(self, cmd: str, args, timeout: float):
        """Run a command on the engine thread (started server) or inline
        (engine thread not running, one process); either way one thread
        at a time touches the engine. Re-raises the command's exception
        here."""
        if not self.is_front:
            raise RuntimeError("a mesh server's control commands enter at "
                               "the mesh's first process")
        done = threading.Event()
        slot: dict = {}
        with self._lock:
            self._control.append((cmd, args, done, slot))
        t = self._engine_thread
        if t is None or not t.is_alive():
            if self._mesh is not None:
                raise RuntimeError("a mesh server runs control commands "
                                   "only on its started engine thread")
            with self._lock:
                cmds, self._control = self._control, []
            self._run_control(self.engine, cmds)
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

    def _run_control(self, eng, cmds: list) -> None:
        """Run control commands ``(cmd, args, done, slot)``; each result
        or exception goes back through its slot (a refused swap reaches
        its caller and never ends the engine thread). ``done`` and
        ``slot`` are None on a mesh's other processes."""
        for cmd, args, done, slot in cmds:
            slot = {} if slot is None else slot
            try:
                if cmd == "swap":
                    slot["result"] = eng.swap_weights(*args)
                elif cmd == "drain":
                    slot["result"] = eng.drain(args)
                else:
                    eng.draining = False
                    slot["result"] = True
                self.control_counts[cmd] += 1
            except Exception as e:  # noqa: BLE001 — handed to the caller
                slot["error"] = e
                if done is None:
                    logger.warning("control command %s refused: %s", cmd, e)
            finally:
                if done is not None:
                    done.set()

    # -- engine thread -------------------------------------------------------

    def _engine_loop(self) -> None:
        try:
            self._engine_loop_inner(self.engine)
        except Exception as e:  # noqa: BLE001 — the engine thread's
            # last act: record why it died (event, bundle, error replies)
            # instead of leaving every client blocked until timeout.
            self._on_engine_crash(e)

    def _on_engine_crash(self, exc: Exception) -> None:
        """Engine-thread postmortem: mark unhealthy, take the
        ``/debug/requests`` snapshot, emit ``serving_engine_crash``, write
        the incident bundle (with ``incident_dir``), and fail every
        waiting client."""
        err = f"{type(exc).__name__}: {exc}"
        self.engine_error = err
        logger.exception("serving engine thread died: %s", err)
        eng = self.engine
        snap = None
        try:
            snap = debug_requests_snapshot(eng)
        except Exception:  # noqa: BLE001 — evidence is best effort; the
            # postmortem must survive a half-broken engine.
            logger.warning("debug snapshot failed during crash postmortem",
                           exc_info=True)
        # The event before the bundle, so its events tail carries it.
        tel.event("serving_engine_crash", error=err,
                  launches=eng.launch_count,
                  weights_version=eng.weights_version,
                  in_flight=eng.in_flight,
                  queue_depth=len(eng.queue))
        if self.incident_dir:
            tel.write_incident_bundle(
                self.incident_dir, reason=err, kind="engine_crash",
                events_tail=tel.current().tail(),
                extra={"launch_count": eng.launch_count,
                       "weights_version": eng.weights_version,
                       "weights_provenance": eng.weights_provenance,
                       "swap_stats": dict(eng.swap_stats)},
                serving=snap)
        with self._lock:
            events, self._events = self._events, {}
            streams, self._streams = self._streams, {}
            for rid, ev in events.items():
                self._done[rid] = {"id": rid,
                                   "error": f"engine crashed: {err}"}
                ev.set()
        for rid, sq in streams.items():
            sq.put(("done", {"id": rid, "error": f"engine crashed: {err}"}))

    def _take_work(self) -> tuple[bool, list, list]:
        """This iteration's (stop, control commands, submissions). On a
        mesh, the first process's, broadcast to every process in one
        collective over the mesh's group; the others' commands carry no
        reply slot."""
        stop = self._stop.is_set()
        with self._lock:
            cmds, self._control = self._control, []
            incoming, self._mailbox = self._mailbox, []
        if self._mesh is None:
            return stop, cmds, incoming
        box = [(stop, [(c, a) for c, a, _d, _s in cmds], incoming)
               if self.is_front else None]
        dist.broadcast_object_list(box, src=self._mesh.first_rank,
                                   group=self.engine._mesh_group)
        if self.is_front:
            return stop, cmds, incoming
        stop, wire, incoming = box[0]
        return stop, [(c, a, None, None) for c, a in wire], incoming

    def _engine_loop_inner(self, eng) -> None:
        while True:
            stop, cmds, incoming = self._take_work()
            if stop:
                return
            self._run_control(eng, cmds)
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
            # Dispatch before the idle check too: a drain finishes
            # requests inside _run_control.
            self._dispatch_completed(eng)
            if eng.idle:
                # An idle mesh still polls: one collective per iteration.
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
        turn's pages under it); ``tenant``: the label of the per-tenant
        latency histograms and trace records."""
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

    def _shed(self) -> dict | None:
        """The refusal gate of POST /generate: a 503 with ``Retry-After``
        after an engine crash, while draining, or once the queue plus the
        mailbox reach ``max_queue_depth``: a bounded refusal beats
        queueing until the client times out."""
        if self.engine_error is not None:
            return {"error": "engine crashed: " + self.engine_error}
        if self.draining:
            return {"error": "draining: not admitting new requests"}
        if self.max_queue_depth > 0:
            with self._lock:
                depth = len(self.engine.queue) + len(self._mailbox)
            if depth >= self.max_queue_depth:
                return {"error": f"queue full (depth {depth} >= "
                                 f"{self.max_queue_depth})"}
        return None

    def _handle_drain(self) -> dict:
        """POST /drain: the drain report's ids and counts (no deadline,
        so nothing is persisted and every in-flight request finishes)."""
        rep = self.drain()
        return {k: rep[k] for k in ("finished", "persisted", "requeued",
                                    "steps", "duration_s")}

    def start(self) -> "ServingServer | None":
        """Bind HTTP (the mesh's first process only) and start the
        engine thread. None when the bind fails."""
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

            def _drain_control(self, path: str) -> None:
                try:
                    if path == "/drain":
                        self._reply(200, server._handle_drain())
                    else:
                        server.resume_admission()
                        self._reply(200, {"status": "ok"})
                except TimeoutError as e:
                    self._reply(504, {"error": str(e)})

            def do_POST(self):  # noqa: N802 — http.server API
                path = self.path.split("?")[0]
                if path in ("/drain", "/resume"):
                    self._drain_control(path)
                    return
                if path != "/generate":
                    self._reply(404, {"error": "try POST /generate"})
                    return
                shed = server._shed()
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
                if path == "/metrics":
                    body = server.metrics.render().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", PROM_CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("Connection", "close")
                    self.close_connection = True
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path == "/debug/requests":
                    self._reply(200, debug_requests_snapshot(eng))
                    return
                self._reply(404, {"error": "try /healthz, /metrics or "
                                           "/debug/requests"})

            def log_message(self, fmt, *args):
                logger.debug("serving http: " + fmt, *args)

        if self.is_front:
            try:
                # All interfaces, as the JAX server binds.
                self._httpd = http.server.ThreadingHTTPServer(
                    ("0.0.0.0", self._requested_port), Handler)
            except OSError as e:
                logger.warning("serving endpoint NOT started (port %s): %s",
                               self._requested_port, e)
                return None
            self.port = self._httpd.server_address[1]
            if self._metrics_owns_port:
                self.metrics.start()
            else:
                # Renderer-only: no second socket, but the observer folds
                # the records GET /metrics on this port reads, from the
                # ambient sink when none was passed.
                sink = self._telemetry if self._telemetry is not None \
                    else tel.current()
                sink.add_observer(self.metrics.observe)
        self._engine_thread = threading.Thread(
            target=self._engine_loop, name="serving-engine", daemon=True)
        self._engine_thread.start()
        if self._httpd is not None:
            self._http_thread = threading.Thread(
                target=self._httpd.serve_forever, name="serving-http",
                daemon=True)
            self._http_thread.start()
            logger.info("serving endpoint on :%d (POST /generate)",
                        self.port)
        return self

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the engine thread ends (a mesh's stop reaches its
        other processes through the broadcast). True when it has."""
        t = self._engine_thread
        if t is not None:
            t.join(timeout)
        return t is None or not t.is_alive()

    def stop(self) -> None:
        """Stop the HTTP front + engine thread. Joins time out after 5 s
        so a wedged step cannot hang teardown; stragglers are counted in
        ``leaked_threads`` and the ``serving_stop`` event."""
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.metrics.stop()
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


def engine_config_from_yaml(plan, engine_block: dict):
    """conf/serving/*.yaml ``engine:`` block → EngineConfig, with 0 or
    empty meaning "take the plan's value" (``engine_config_for_plan``)."""
    from distributed_training_tpu_torch.serving.disagg import (
        engine_config_for_plan,
    )

    base = engine_config_for_plan(
        plan, page_size=int(engine_block.get("page_size", 16)),
        prefill_chunk=int(engine_block.get("prefill_chunk", 16)))
    # 0 / empty keeps the plan-derived value for every knob (temperature
    # 0 is the plan's greedy default; prefill_slots 0 and spec_k 1 mean
    # the defaults anyway).
    over = {k: v for k, v in engine_block.items()
            if k in ("max_batch", "num_pages", "max_seq_len", "policy",
                     "temperature", "top_k", "prefill_slots",
                     "prefill_mode", "spec_k", "spec_ngram", "resident_k",
                     "eos_id")
            and v not in (0, 0.0, None, "")}
    # prefix_sharing is a real boolean: False == 0 would fall into the
    # filter above and silently re-enable it.
    if engine_block.get("prefix_sharing") is not None:
        over["prefix_sharing"] = bool(engine_block["prefix_sharing"])
    # swap_staleness_tokens 0 is a meaningful bound (preempt everything
    # in flight at a swap); -1 or absent is unbounded.
    if engine_block.get("swap_staleness_tokens") is not None:
        over["swap_staleness_tokens"] = int(
            engine_block["swap_staleness_tokens"])
    return dataclasses.replace(base, **over)


def _serving_runtime(plan, device):
    """The runtime of ``plan``'s mesh: None at a mesh of 1 in a world of
    one process; otherwise this process's rank of the mesh over the
    world that ``RANK``/``WORLD_SIZE``/``MASTER_*`` describe (as the
    trainer's ``initialize_runtime`` takes it), its collectives bounded
    by ``MESH_TIMEOUT_S``."""
    from distributed_training_tpu_torch.parallel.planner import (
        plan_mesh_spec,
    )
    from distributed_training_tpu_torch.runtime import initialize_runtime

    cfg = types.SimpleNamespace(
        train=types.SimpleNamespace(
            device="cpu" if device.type == "cpu" else "auto"),
        mesh=types.SimpleNamespace(**plan_mesh_spec(plan).as_dict()))
    rt = initialize_runtime(
        cfg, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    return rt if rt.mesh is not None else None


def build_server(artifact: str, plan_name: str, port: int = 0,
                 metrics_port: int | None = None,
                 telemetry=None,
                 engine_block: dict | None = None,
                 server_block: dict | None = None,
                 device=None) -> ServingServer:
    """Artifact + plan → laid-out, warmed engine → server (not started).

    ``device`` None is the CUDA card (raises without one), "cpu" the CPU.
    A plan whose mesh is larger than 1 takes its world from the
    environment (``torchrun``), one process per mesh rank. The
    provenance gate lives in ``WeightStore``: an artifact whose recorded
    plan no longer matches the committed fingerprint refuses to serve."""
    from distributed_training_tpu_torch.parallel.planner import (
        load_plan,
        model_for_plan,
    )
    from distributed_training_tpu_torch.runtime import resolve_device
    from distributed_training_tpu_torch.serving.disagg import WeightStore
    from distributed_training_tpu_torch.serving.engine import Engine

    device = resolve_device(device)
    plan = load_plan(plan_name)
    store = WeightStore(artifact)
    rt = _serving_runtime(plan, device)
    device = rt.device if rt is not None else device
    model = model_for_plan(plan, device=device)
    engine = Engine(model, store.params_for(rt, plan, device),
                    engine_config_from_yaml(plan, engine_block or {}),
                    mesh=rt, device=device,
                    weights_provenance=store.provenance)
    del store
    engine.warmup()
    sb = server_block or {}
    return ServingServer(
        engine, port=port, metrics_port=metrics_port, telemetry=telemetry,
        max_queue_depth=int(sb.get("max_queue_depth", 0) or 0),
        retry_after_s=float(sb.get("retry_after_s", 1.0) or 1.0),
        incident_dir=sb.get("incident_dir"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_training_tpu_torch.serving.server",
        description="Continuous-batching inference server.")
    ap.add_argument("--artifact", required=True,
                    help="consolidated export (checkpoint/export.py)")
    ap.add_argument("--plan", default=None,
                    help="committed decode plan name (conf/plans/) or a "
                         "plan file; default: the --config file's plan")
    ap.add_argument("--config", default=None,
                    help="serving YAML (conf/serving/default.yaml): "
                         "engine geometry, scheduling policy, ports; "
                         "explicit flags win per key")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--metrics-port", type=int, default=None)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="the CUDA card (default; raises without one) or "
                         "the CPU")
    args = ap.parse_args(argv)
    from distributed_training_tpu_torch.runtime import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: raise now

    conf: dict = {}
    if args.config:
        import yaml
        with open(args.config) as f:
            conf = yaml.safe_load(f) or {}
    plan_name = args.plan or conf.get("plan")
    if not plan_name:
        ap.error("no plan: pass --plan or a --config with one")
    srv_conf = conf.get("server") or {}
    port = args.port if args.port is not None \
        else int(srv_conf.get("port", 8100))
    mp_conf = srv_conf.get("metrics_port", 8101)
    # metrics_port: null in the config = no standalone endpoint; the
    # serving port's own GET /metrics still works (renderer-only).
    metrics_port = args.metrics_port if args.metrics_port is not None \
        else (int(mp_conf) if mp_conf is not None else None)
    if not srv_conf.get("incident_dir"):
        srv_conf = {**srv_conf, "incident_dir": os.path.join(
            "outputs", "serving", "incidents")}
    # The sink must be enabled (jsonl-backed) for the observer chain to
    # fire. On a mesh only the first process records: it alone answers
    # clients, and the other processes' records would repeat its own.
    rank = int(os.environ.get("RANK", "0"))
    sink = None
    if rank == 0:
        sink = tel.install(tel.Telemetry(events_jsonl=os.path.join(
            "outputs", "serving", "events.jsonl")))
    srv = build_server(args.artifact, plan_name, port=port,
                       metrics_port=metrics_port, telemetry=sink,
                       engine_block=conf.get("engine") or {},
                       server_block=srv_conf, device=args.device)
    try:
        if srv.start() is None:
            return 1
        print(json.dumps({"serving": "ready", "port": srv.port,
                          "metrics_port": srv.metrics.port,
                          "front": srv.is_front,
                          "kernel_launches": kernel_launches()}),
              flush=True)
        try:
            # The front serves (503s after a crash) until interrupted;
            # the mesh's other processes until the front's stop reaches
            # them, or their engine thread dies.
            while srv.is_front or not srv.wait(timeout=0.5):
                time.sleep(0.5)
        except KeyboardInterrupt:
            logger.info("interrupted: stopping the server")
        srv.stop()
        eng = srv.engine
        print(json.dumps({"serving": "stopped",
                          "requests_finished": eng.finished_total,
                          "control": dict(srv.control_counts),
                          "draining": eng.draining,
                          "engine_error": srv.engine_error,
                          "leaked_threads": srv.leaked_threads,
                          "kernel_launches": kernel_launches()}),
              flush=True)
        return 0 if srv.engine_error is None else 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        if sink is not None:
            sink.close()


if __name__ == "__main__":
    sys.exit(main())
