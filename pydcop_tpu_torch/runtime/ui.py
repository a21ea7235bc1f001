"""Live observation server.

The port of the JAX package's ``runtime/ui.py`` (the reference's
pydcop/infrastructure/ui.py, UiServer :43-120), speaking the SAME
websocket protocol to GUI clients — via the stdlib RFC 6455
implementation in ``runtime/ws.py``:

* client commands (JSON ``{"cmd": ...}``): ``test``, ``agent``,
  ``computations`` — answered with ``{"cmd": ..., ...}`` payloads in
  the reference's shapes (ui.py:118-195);
* pushed events (JSON ``{"evt": ...}``): ``cycle``, ``value``,
  ``add_comp``, ``rem_comp`` from the event bus, one envelope
  ``{"evt": family, "kind": ..., "data": ...}`` per event family
  (:data:`FAMILIES`: faults, integrity, elastic, repair, batch, harness,
  shard, dpop, search, serve, memo, fleet, portfolio, slo — the families
  this package does not emit yet are formatted all the same), and an
  application-level ``{"cmd": "close"}`` on shutdown (ui.py:89-91).

An HTTP fallback runs alongside on ``port``:

* ``GET /state``  — current status, cycle, cost, assignment (JSON);
* ``GET /events`` — Server-Sent Events stream of event-bus topics
  (consumable from any browser/EventSource, no extra deps).

The websocket endpoint listens on ``ws_port`` (default ``port + 1``,
matching the reference's one-ws-port-per-agent layout).  ``stop()``
unsubscribes every callback it subscribed.  :func:`serving` is the
commands' ``--uiport`` lifecycle.
"""
from __future__ import annotations

import json
import queue
import threading
from contextlib import contextmanager
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterator, Optional

from pydcop_tpu_torch.runtime.events import event_bus

#: event families pushed to ws clients: bus topic prefix → ``evt`` name
FAMILIES: Dict[str, str] = {
    "faults": "fault",
    "integrity": "integrity",
    "elastic": "elastic",
    "repair": "repair",
    "batch": "batch",
    "harness": "harness",
    "shard": "shard",
    "dpop": "dpop",
    "search": "search",
    "serve": "serve",
    "memo": "memo",
    "fleet": "fleet",
    "portfolio": "portfolio",
    "slo": "slo",
}

_JSONABLE = (dict, list, str, int, float, bool, type(None))


class UiServer:
    def __init__(self, port: int = 10001, address: str = "127.0.0.1",
                 ws_port: Optional[int] = None, orchestrator=None):
        self.port = port
        self.ws_port = ws_port if ws_port is not None else port + 1
        self.address = address
        self.orchestrator = orchestrator
        self._state = {"status": "INITIAL"}
        self._lock = threading.Lock()
        self._subscribers: list[queue.Queue] = []
        self._server: Optional[ThreadingHTTPServer] = None
        self._ws = None
        self._subscribed = [
            ("*", self._on_event),
            ("computations.cycle.*", self._cb_cycle),
            ("computations.value.*", self._cb_value),
            ("agents.add_computation.*", self._cb_add_comp),
            ("agents.rem_computation.*", self._cb_rem_comp),
        ] + [(f"{prefix}.*", self._family_cb(evt))
             for prefix, evt in FAMILIES.items()]
        for topic, cb in self._subscribed:
            event_bus.subscribe(topic, cb)

    # -- event plumbing -----------------------------------------------------

    def _on_event(self, topic: str, evt) -> None:
        payload = json.dumps({"topic": topic, "event": repr(evt)})
        with self._lock:
            for q in list(self._subscribers):
                try:
                    q.put_nowait(payload)
                except queue.Full:
                    pass

    def update_state(self, **kwargs) -> None:
        with self._lock:
            self._state.update(kwargs)

    # -- websocket protocol (reference ui.py command/event shapes) ----------

    def _ws_message(self, client, text: str) -> None:
        try:
            msg = json.loads(text)
        except ValueError:
            return
        cmd = msg.get("cmd") if isinstance(msg, dict) else None
        if cmd == "test":
            self._ws.send_all(json.dumps({"cmd": "test", "data": "foo"}))
        elif cmd == "agent":
            self._ws.send(client, json.dumps(
                {"cmd": "agent", "agent": self._agent_data()}))
        elif cmd == "computations":
            self._ws.send(client, json.dumps(
                {"cmd": "computations",
                 "computations": self._computations()}))

    def _agent_data(self) -> dict:
        """The reference's agent payload (ui.py:135-147), with the
        virtual orchestrator standing in for the per-agent view."""
        with self._lock:
            state = dict(self._state)
        return {
            "name": "orchestrator",
            "extra": {},
            "computations": self._computations(),
            "replicas": self._replicas(),
            "address": f"{self.address}:{self.port}",
            "is_orchestrator": True,
            "status": state.get("status"),
        }

    def _computations(self) -> list:
        """The reference's computation payloads (ui.py:155-194)."""
        orch = self.orchestrator
        if orch is None:
            return []
        with self._lock:
            assignment = dict(self._state.get("assignment") or {})
        # mid-run values: the last completed phase's assignment (the
        # end metrics only land in _state after the run)
        last = getattr(orch, "_last_result", None)
        if not assignment and last is not None:
            assignment = dict(last.assignment or {})
        algo = {"name": orch.algo_def.algo,
                "params": dict(orch.algo_def.params)}
        out = []
        for node in orch.cg.nodes:
            # variable-vs-factor from the node class, not from the
            # assignment (which is empty before the first phase ends)
            is_var = hasattr(node, "variable")
            out.append({
                "id": node.name,
                "name": node.name,
                "type": "variable" if is_var else "factor",
                "value": assignment.get(node.name),
                "neighbors": list(node.neighbors),
                "algo": algo,
                "msg_count": 0,
                "msg_size": 0,
                "cycles": self._state.get("cycle", 0),
                "footprint": orch.algo_module.computation_memory(node),
            })
        return out

    def _replicas(self) -> list:
        orch = self.orchestrator
        if orch is None or orch.replicas is None:
            return []
        return sorted(orch.replicas.mapping())

    def _cb_cycle(self, topic: str, evt) -> None:
        if self._ws is not None:
            self._ws.send_all(json.dumps(
                {"evt": "cycle", "computation": topic.rsplit(".", 1)[-1],
                 "cycles": evt}))

    def _cb_value(self, topic: str, evt) -> None:
        if self._ws is not None:
            self._ws.send_all(json.dumps(
                {"evt": "value", "computation": topic.rsplit(".", 1)[-1],
                 "value": evt}))

    def _cb_add_comp(self, topic: str, evt) -> None:
        if self._ws is not None:
            self._ws.send_all(json.dumps(
                {"evt": "add_comp", "computation": evt}))

    def _cb_rem_comp(self, topic: str, evt) -> None:
        if self._ws is not None:
            self._ws.send_all(json.dumps(
                {"evt": "rem_comp", "computation": evt}))

    def _family_cb(self, family: str) -> Callable[[str, object], None]:
        """The callback of one event family: its events pushed to GUI
        clients as ``{"evt": family, "kind": <topic past the prefix>,
        "data": <payload, or its repr>}``; the SSE /events stream gets
        them through the wildcard subscription like every topic."""

        def push(topic: str, evt) -> None:
            if self._ws is not None:
                self._ws.send_all(json.dumps(
                    {"evt": family,
                     "kind": topic.split(".", 1)[-1],
                     "data": evt if isinstance(evt, _JSONABLE)
                     else repr(evt)}))

        return push

    # -- server -------------------------------------------------------------

    def start(self) -> None:
        ui = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/state":
                    with ui._lock:
                        body = json.dumps(ui._state).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/events":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    q: queue.Queue = queue.Queue(maxsize=1000)
                    with ui._lock:
                        ui._subscribers.append(q)
                    try:
                        while True:
                            payload = q.get(timeout=30)
                            self.wfile.write(
                                f"data: {payload}\n\n".encode()
                            )
                            self.wfile.flush()
                    except (queue.Empty, OSError):
                        pass
                    finally:
                        with ui._lock:
                            if q in ui._subscribers:
                                ui._subscribers.remove(q)
                else:
                    self.send_response(404)
                    self.end_headers()

        self._server = ThreadingHTTPServer((self.address, self.port),
                                           Handler)
        thread = threading.Thread(target=self._server.serve_forever,
                                  daemon=True)
        thread.start()

        from pydcop_tpu_torch.runtime.ws import WebSocketServer

        self._ws = WebSocketServer(
            self.ws_port, host=self.address, on_message=self._ws_message
        )
        self._ws.start()

    def stop(self) -> None:
        for _topic, cb in self._subscribed:
            event_bus.unsubscribe(cb)
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._ws is not None:
            # application-level close first (reference ui.py:89-91: the
            # ws close alone does not reach the GUI client)
            self._ws.send_all(json.dumps({"cmd": "close"}))
            self._ws.stop()
            self._ws = None


@contextmanager
def serving(port: Optional[int],
            orchestrator=None) -> Iterator[Optional[UiServer]]:
    """A started :class:`UiServer` on ``port`` for the block (``None``
    and nothing served when ``port`` is unset): the event bus publishes
    while it serves and gets its state back after."""
    if not port:
        yield None
        return
    bus_was, event_bus.enabled = event_bus.enabled, True
    ui = UiServer(port=port, orchestrator=orchestrator)
    ui.start()
    try:
        yield ui
    finally:
        ui.stop()
        event_bus.enabled = bus_was
