"""The port's UI tier on the CPU: ``runtime/ws.py`` (the stdlib RFC 6455
server) and ``runtime/ui.py`` (``UiServer``: the ws protocol, HTTP
``/state`` and the SSE stream), held to the JAX package's, after its
``tests/unit/test_ui_websocket.py``:

* frames equal the JAX package's ``encode_frame`` byte for byte (masked
  and unmasked; the 7-, 16- and 64-bit lengths; text, ping, pong,
  close), each package's ``read_frame`` decodes the other's, and the
  handshake's accept key is the JAX package's;
* the ``test``/``agent``/``computations`` commands answer the JAX
  package's payloads for the same orchestrator state, and ``/state``
  carries the same JSON;
* every event family (those the port does not emit yet too) arrives in
  the JAX package's envelope; the SSE stream carries every topic;
* ping/pong, bad messages, a pipelined first frame, an oversized frame
  and the close message behave as in the JAX package; ``stop()``
  unsubscribes every callback.

Every socket has a timeout of a few seconds: a hung accept or read fails
the test instead of holding the suite.
"""
import base64
import hashlib
import http.client
import json
import os
import socket
import struct
import time

import pytest

from pydcop_tpu.dcop import load_dcop_from_file as jax_load_dcop
from pydcop_tpu.runtime import ws as jax_ws
from pydcop_tpu.runtime.events import event_bus as jax_bus
from pydcop_tpu.runtime.orchestrator import \
    VirtualOrchestrator as JaxOrchestrator
from pydcop_tpu.runtime.ui import UiServer as JaxUiServer
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.runtime import ws
from pydcop_tpu_torch.runtime.events import event_bus
from pydcop_tpu_torch.runtime.orchestrator import VirtualOrchestrator
from pydcop_tpu_torch.runtime.ui import FAMILIES, UiServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUTO = os.path.join(ROOT, "tests", "instances", "graph_coloring_tuto.yaml")
TIMEOUT = 5


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class WsClient:
    """Stdlib test client: handshake + masked text frames, with a given
    package's frame functions."""

    def __init__(self, port, frames=ws):
        self.frames = frames
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=TIMEOUT)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall(
            f"GET / HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
            f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            f"Sec-WebSocket-Version: 13\r\n\r\n".encode())
        resp = b""
        while b"\r\n\r\n" not in resp:
            resp += self.sock.recv(4096)
        assert b"101" in resp.split(b"\r\n", 1)[0]
        assert jax_ws._accept_key(key).encode() in resp

    def send_json(self, obj):
        self.sock.sendall(self.frames.encode_frame(
            json.dumps(obj).encode(), self.frames.OP_TEXT, mask=True))

    def recv_json(self):
        self.sock.settimeout(TIMEOUT)
        opcode, payload = self.frames.read_frame(self.sock)
        assert opcode == self.frames.OP_TEXT, opcode
        return json.loads(payload.decode())

    def close(self):
        self.sock.close()


def _wait_clients(ui, n, deadline=TIMEOUT):
    """The handshake completes before the server registers the client:
    wait for the registration before broadcasting."""
    t0 = time.time()
    while ui._ws.n_clients < n:
        if time.time() - t0 > deadline:
            raise AssertionError("ws client not registered in time")
        time.sleep(0.01)


def _send(bus, topic, payload):
    was = bus.enabled
    bus.enabled = True
    try:
        bus.send(topic, payload)
    finally:
        bus.enabled = was


@pytest.fixture
def served():
    orch = VirtualOrchestrator(load_dcop_from_file(TUTO), "maxsum",
                               distribution="adhoc", device="cpu")
    orch.deploy_computations()
    ui = UiServer(port=free_port(), ws_port=free_port(), orchestrator=orch)
    ui.start()
    yield orch, ui
    ui.stop()


# ---------------------------------------------------------------------------
# frames and the handshake
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 125, 126, 127, 65535, 65536, 70000])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("opcode", [ws.OP_TEXT, ws.OP_PING, ws.OP_PONG,
                                    ws.OP_CLOSE])
def test_frames_equal_jax(n, mask, opcode):
    payload = bytes((i * 7 + n) % 256 for i in range(n))
    frame = ws.encode_frame(payload, opcode, mask=mask)
    assert frame == jax_ws.encode_frame(payload, opcode, mask=mask)

    class Reader:
        def __init__(self, data):
            self.data = data

        def recv(self, k):
            out, self.data = self.data[:k], self.data[k:]
            return out

    assert ws.read_frame(Reader(frame)) == (opcode, payload)
    assert jax_ws.read_frame(Reader(frame)) == (opcode, payload)


def test_read_frame_edges_equal_jax():
    class Reader:
        def __init__(self, data):
            self.data = data

        def recv(self, k):
            out, self.data = self.data[:k], self.data[k:]
            return out

    cases = [b"", b"\x81", b"\x81\x05abc",
             bytes([0x81, 127]) + struct.pack(">Q", ws.MAX_PAYLOAD + 1),
             bytes([0x81, 0x80 | 3]) + b"\x01\x02"]
    for data in cases:
        assert ws.read_frame(Reader(data)) == \
            jax_ws.read_frame(Reader(data))


@pytest.mark.parametrize("key", ["dGhlIHNhbXBsZSBub25jZQ==",
                                 base64.b64encode(b"0123456789abcdef")
                                 .decode()])
def test_accept_key_equals_jax(key):
    assert ws._accept_key(key) == jax_ws._accept_key(key)
    if key == "dGhlIHNhbXBsZSBub25jZQ==":  # RFC 6455's own example
        assert ws._accept_key(key) == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="
    digest = hashlib.sha1((key + ws._GUID).encode()).digest()
    assert ws._accept_key(key) == base64.b64encode(digest).decode()


def test_jax_client_against_the_port_server(served):
    """The JAX package's frame functions talk to the port's server."""
    _, ui = served
    c = WsClient(ui.ws_port, frames=jax_ws)
    try:
        c.send_json({"cmd": "test"})
        assert c.recv_json() == {"cmd": "test", "data": "foo"}
    finally:
        c.close()


# ---------------------------------------------------------------------------
# the protocol, held to the JAX package's server
# ---------------------------------------------------------------------------


def test_commands_equal_jax():
    """The same orchestrator state (maxsum at noise 0 on the generic
    engines, 5 cycles) answers the same payloads in both packages."""
    from pydcop_tpu.algorithms import AlgorithmDef as JaxAlgorithmDef
    from pydcop_tpu_torch.algorithms import AlgorithmDef
    from pydcop_tpu_torch.algorithms.maxsum import build_solver

    dcop = load_dcop_from_file(TUTO)
    port = VirtualOrchestrator(dcop, AlgorithmDef.build_with_default_params(
        "maxsum", {"noise": 0.0}), distribution="adhoc", device="cpu")
    port.solver = build_solver(dcop, None, port.algo_def, device="cpu",
                               use_packed=False)
    ref = JaxOrchestrator(jax_load_dcop(TUTO),
                          JaxAlgorithmDef.build_with_default_params(
                              "maxsum", {"noise": 0.0}),
                          distribution="adhoc")
    answers = []
    for orch, server in ((port, UiServer), (ref, JaxUiServer)):
        orch.deploy_computations()
        orch.start_replication(2)
        orch.run(cycles=5)
        ui = server(port=free_port(), ws_port=free_port(),
                    orchestrator=orch)
        ui.start()
        try:
            ui.update_state(**orch.end_metrics())
            c = WsClient(ui.ws_port)
            try:
                got = []
                for cmd in ("test", "agent", "computations"):
                    c.send_json({"cmd": cmd})
                    got.append(c.recv_json())
            finally:
                c.close()
            conn = http.client.HTTPConnection("127.0.0.1", ui.port,
                                              timeout=TIMEOUT)
            conn.request("GET", "/state")
            state = json.loads(conn.getresponse().read())
            conn.close()
        finally:
            ui.stop()
        got[1]["agent"]["address"] = None  # the ports differ
        answers.append((got, state))
    (got, state), (want, want_state) = answers
    assert got == want
    assert set(state) == set(want_state)
    for k in ("status", "assignment", "cost", "distribution", "replicas",
              "events", "resilience", "cycle"):
        assert state[k] == want_state[k], k
    comps = {m["name"]: m for m in got[2]["computations"]}
    assert comps["v1"]["type"] == "variable" and comps["v1"]["value"] == "G"
    assert comps["c_1_2"]["type"] == "factor"


def test_events_are_pushed(served):
    _, ui = served
    c = WsClient(ui.ws_port)
    try:
        _wait_clients(ui, 1)
        _send(event_bus, "computations.value.v1", "R")
        assert c.recv_json() == {"evt": "value", "computation": "v1",
                                 "value": "R"}
        _send(event_bus, "computations.cycle.*", 12)
        assert c.recv_json() == {"evt": "cycle", "computation": "*",
                                 "cycles": 12}
        _send(event_bus, "agents.add_computation.a1", "v3")
        assert c.recv_json() == {"evt": "add_comp", "computation": "v3"}
        _send(event_bus, "agents.rem_computation.a1", "v3")
        assert c.recv_json() == {"evt": "rem_comp", "computation": "v3"}
    finally:
        c.close()


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("payload", [{"jid": "j1", "cycle": 3},
                                     ("not", "json-able")])
def test_family_envelopes_equal_jax(family, payload):
    """One event of each family reaches the port's and the JAX package's
    clients in the same envelope (a payload that is not JSON-able
    travels as its repr)."""
    got = []
    for server, bus in ((UiServer, event_bus), (JaxUiServer, jax_bus)):
        ui = server(port=free_port(), ws_port=free_port())
        ui.start()
        try:
            c = WsClient(ui.ws_port)
            try:
                _wait_clients(ui, 1)
                _send(bus, f"{family}.some.kind", payload)
                got.append(c.recv_json())
            finally:
                c.close()
        finally:
            ui.stop()
    assert got[0] == got[1]
    assert got[0]["evt"] == FAMILIES[family]
    assert got[0]["kind"] == "some.kind"


def test_orchestrator_run_pushes_cycles_and_faults(served):
    """A scenario run with the bus on: each phase pushes its cycle
    count, and the removal its fault and computation events."""
    from pydcop_tpu_torch.dcop import DcopEvent, EventAction, Scenario

    orch, ui = served
    orch.start_replication(2)
    c = WsClient(ui.ws_port)
    try:
        _wait_clients(ui, 1)
        was = event_bus.enabled
        event_bus.enabled = True
        try:
            orch.run(Scenario([
                DcopEvent("d1", delay=600.0),
                DcopEvent("e1", actions=[EventAction("remove_agent",
                                                     agent="a1")]),
                DcopEvent("d2", delay=600.0)]), cycles=4)
        finally:
            event_bus.enabled = was
        seen = []
        while not any(m.get("evt") == "cycle" and m["cycles"] == 12
                      for m in seen):
            seen.append(c.recv_json())
        cycles = [m["cycles"] for m in seen if m.get("evt") == "cycle"]
        assert cycles == [4, 8, 12]
        kinds = {m.get("kind") for m in seen if m.get("evt") == "fault"}
        assert "recovered.repair" in kinds
    finally:
        c.close()


def test_sse_stream_carries_topics(served):
    _, ui = served
    conn = http.client.HTTPConnection("127.0.0.1", ui.port, timeout=TIMEOUT)
    conn.request("GET", "/events")
    resp = conn.getresponse()
    assert resp.status == 200
    t0 = time.time()
    while not ui._subscribers and time.time() - t0 < TIMEOUT:
        time.sleep(0.01)
    _send(event_bus, "faults.injected.kill_agent", {"agents": ["a1"]})
    line = resp.fp.readline().decode()
    assert line.startswith("data: ")
    body = json.loads(line[6:])
    assert body == {"topic": "faults.injected.kill_agent",
                    "event": repr({"agents": ["a1"]})}
    conn.close()


def test_unknown_path_is_404(served):
    _, ui = served
    conn = http.client.HTTPConnection("127.0.0.1", ui.port, timeout=TIMEOUT)
    conn.request("GET", "/nope")
    assert conn.getresponse().status == 404
    conn.close()


def test_close_message_on_stop(served):
    _, ui = served
    c = WsClient(ui.ws_port)
    _wait_clients(ui, 1)
    ui.stop()
    assert c.recv_json() == {"cmd": "close"}
    c.close()


def test_stop_unsubscribes_every_callback():
    """The port's stop() leaves no subscription behind (the JAX package's
    stop() leaves its integrity, elastic and search callbacks
    subscribed; ROADMAP C-f3)."""
    before = len(event_bus._subs)
    ui = UiServer(port=free_port(), ws_port=free_port())
    assert len(event_bus._subs) == before + 5 + len(FAMILIES)
    ui.start()
    ui.stop()
    assert len(event_bus._subs) == before
    jbefore = len(jax_bus._subs)
    jui = JaxUiServer(port=free_port(), ws_port=free_port())
    jui.start()
    jui.stop()
    assert len(jax_bus._subs) == jbefore + 3


def test_ping_pong(served):
    _, ui = served
    c = WsClient(ui.ws_port)
    try:
        c.sock.sendall(ws.encode_frame(b"hb", ws.OP_PING, mask=True))
        assert ws.read_frame(c.sock) == (ws.OP_PONG, b"hb")
    finally:
        c.close()


def test_bad_messages_do_not_kill_connection(served):
    _, ui = served
    c = WsClient(ui.ws_port)
    try:
        _wait_clients(ui, 1)
        for bad in ('[1]', '"hello"', "not json", '{"cmd": "nope"}'):
            c.sock.sendall(ws.encode_frame(bad.encode(), ws.OP_TEXT,
                                           mask=True))
        c.send_json({"cmd": "test"})
        assert c.recv_json() == {"cmd": "test", "data": "foo"}
    finally:
        c.close()


def test_pipelined_first_frame_not_lost(served):
    _, ui = served
    sock = socket.create_connection(("127.0.0.1", ui.ws_port),
                                    timeout=TIMEOUT)
    key = base64.b64encode(os.urandom(16)).decode()
    frame = ws.encode_frame(json.dumps({"cmd": "test"}).encode(),
                            ws.OP_TEXT, mask=True)
    sock.sendall(
        f"GET / HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
        f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
        f"Sec-WebSocket-Version: 13\r\n\r\n".encode() + frame)
    resp = b""
    while b"\r\n\r\n" not in resp:
        resp += sock.recv(4096)
    reader = ws._BufferedSock(sock, resp.split(b"\r\n\r\n", 1)[1])
    opcode, payload = ws.read_frame(reader)
    assert opcode == ws.OP_TEXT
    assert json.loads(payload) == {"cmd": "test", "data": "foo"}
    sock.close()


def test_oversized_frame_is_refused(served):
    _, ui = served
    c = WsClient(ui.ws_port)
    _wait_clients(ui, 1)
    c.sock.sendall(bytes([0x81, 0x80 | 127]) + struct.pack(">Q", 1 << 40))
    t0 = time.time()
    while ui._ws.n_clients > 0 and time.time() - t0 < TIMEOUT:
        time.sleep(0.05)
    assert ui._ws.n_clients == 0
    c.close()


def test_handshake_without_key_is_dropped(served):
    _, ui = served
    sock = socket.create_connection(("127.0.0.1", ui.ws_port),
                                    timeout=TIMEOUT)
    sock.sendall(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
    assert sock.recv(16) == b""
    sock.close()
    assert ui._ws.n_clients == 0
