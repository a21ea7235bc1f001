"""Minimal RFC 6455 WebSocket server — stdlib only.

A copy of the JAX package's ``runtime/ws.py``: frames and the handshake's
accept key byte for byte.  The reference's UiServer speaks websockets via
the ``websocket-server`` package (pydcop/infrastructure/ui.py:43-120);
this module implements the small subset of RFC 6455 the GUI protocol
needs with nothing but ``socket``/``hashlib``/``base64``:

* HTTP Upgrade handshake (Sec-WebSocket-Accept);
* text frames in both directions (client→server frames are masked per
  the RFC, server→client unmasked), with 7/16/64-bit payload lengths;
* close (0x8) handshake and ping (0x9) → pong (0xA).

One thread per client, same threading model as the reference's server.
"""
from __future__ import annotations

import base64
import hashlib
import socket
import struct
import threading
from typing import Callable, List, Optional

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_TEXT = 0x1
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA

#: refuse frames beyond this payload size — the length field is
#: client-controlled, and an uncapped 64-bit length is a trivial
#: memory-exhaustion vector
MAX_PAYLOAD = 8 * 2**20


class _BufferedSock:
    """recv() facade draining handshake-leftover bytes first (a client
    may pipeline its first frame with the HTTP upgrade request)."""

    def __init__(self, sock: socket.socket, leftover: bytes = b""):
        self._sock = sock
        self._buf = leftover

    def recv(self, n: int) -> bytes:
        if self._buf:
            out, self._buf = self._buf[:n], self._buf[n:]
            return out
        return self._sock.recv(n)


def _accept_key(key: str) -> str:
    digest = hashlib.sha1((key + _GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def encode_frame(payload: bytes, opcode: int = OP_TEXT,
                 mask: bool = False) -> bytes:
    """One FIN frame.  ``mask=True`` produces a client-side frame (the
    RFC requires clients to mask) — used by the test client."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    mask_bit = 0x80 if mask else 0
    if n < 126:
        head += bytes([mask_bit | n])
    elif n < 1 << 16:
        head += bytes([mask_bit | 126]) + struct.pack(">H", n)
    else:
        head += bytes([mask_bit | 127]) + struct.pack(">Q", n)
    if mask:
        key = struct.pack(">I", 0x37FA213D)
        masked = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
        return head + key + masked
    return head + payload


def read_frame(sock):
    """(opcode, payload) of the next frame, or (None, b"") on EOF or an
    oversized frame.  ``sock`` needs only a ``recv`` method."""

    def read_exact(n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("peer closed")
            buf += chunk
        return buf

    try:
        b0, b1 = read_exact(2)
    except (ConnectionError, OSError):
        return None, b""
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    n = b1 & 0x7F
    try:
        if n == 126:
            (n,) = struct.unpack(">H", read_exact(2))
        elif n == 127:
            (n,) = struct.unpack(">Q", read_exact(8))
        if n > MAX_PAYLOAD:
            return None, b""
        key = read_exact(4) if masked else None
        payload = read_exact(n) if n else b""
    except (ConnectionError, OSError):
        return None, b""
    if key:
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return opcode, payload


class WebSocketServer:
    """Tiny multicast websocket server.

    ``on_message(client_socket, text)`` is called for every text frame;
    reply with :meth:`send` / :meth:`send_all`.
    """

    def __init__(
        self,
        port: int,
        host: str = "127.0.0.1",
        on_message: Optional[Callable[[socket.socket, str], None]] = None,
    ):
        self.host, self.port = host, port
        self.on_message = on_message
        self._clients: List[socket.socket] = []
        # per-client write locks: command replies and event broadcasts
        # come from different threads, and interleaved sendall calls
        # would corrupt the frame stream
        self._write_locks: dict = {}
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._running = False

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._sock = socket.create_server(
            (self.host, self.port), reuse_port=False
        )
        self._sock.settimeout(0.5)
        self._running = True
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"ws-accept-{self.port}").start()

    def stop(self) -> None:
        self._running = False
        with self._lock:
            clients, self._clients = self._clients, []
        for c in clients:
            try:
                c.sendall(encode_frame(b"", OP_CLOSE))
                c.close()
            except OSError:
                pass
        if self._sock is not None:
            self._sock.close()

    # -- plumbing -----------------------------------------------------------

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve_client, args=(conn,),
                             daemon=True).start()

    def _serve_client(self, conn: socket.socket) -> None:
        try:
            leftover = self._handshake(conn)
            if leftover is None:
                conn.close()
                return
        except OSError:
            conn.close()
            return
        with self._lock:
            self._clients.append(conn)
            self._write_locks[conn] = threading.Lock()
        reader = _BufferedSock(conn, leftover)
        try:
            while self._running:
                opcode, payload = read_frame(reader)
                if opcode is None or opcode == OP_CLOSE:
                    break
                if opcode == OP_PING:
                    with self._lock:
                        wlock = self._write_locks.get(conn)
                    if wlock is None:  # a failed send() dropped the client
                        break
                    with wlock:
                        conn.sendall(encode_frame(payload, OP_PONG))
                elif opcode == OP_TEXT and self.on_message is not None:
                    try:
                        self.on_message(conn, payload.decode("utf-8"))
                    except Exception:  # noqa: BLE001 — one bad message
                        pass  # must not take the connection down
        finally:
            with self._lock:
                if conn in self._clients:
                    self._clients.remove(conn)
                self._write_locks.pop(conn, None)
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _handshake(conn: socket.socket) -> Optional[bytes]:
        """Returns bytes received past the header terminator (a client
        may pipeline its first frame with the upgrade request), or None
        on a failed handshake."""
        conn.settimeout(5)
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = conn.recv(4096)
            if not chunk:
                return None
            data += chunk
        head, _, leftover = data.partition(b"\r\n\r\n")
        headers = {}
        for line in head.split(b"\r\n")[1:]:
            if b":" in line:
                k, v = line.split(b":", 1)
                headers[k.strip().lower()] = v.strip()
        key = headers.get(b"sec-websocket-key")
        if key is None:
            return None
        conn.sendall(
            b"HTTP/1.1 101 Switching Protocols\r\n"
            b"Upgrade: websocket\r\n"
            b"Connection: Upgrade\r\n"
            b"Sec-WebSocket-Accept: "
            + _accept_key(key.decode()).encode() + b"\r\n\r\n"
        )
        conn.settimeout(None)
        return leftover

    # -- sending ------------------------------------------------------------

    def send(self, client: socket.socket, text: str) -> None:
        with self._lock:
            wlock = self._write_locks.get(client)
        if wlock is None:
            return  # client already gone
        try:
            with wlock:
                client.sendall(encode_frame(text.encode("utf-8")))
        except OSError:
            with self._lock:
                if client in self._clients:
                    self._clients.remove(client)
                self._write_locks.pop(client, None)

    def send_all(self, text: str) -> None:
        with self._lock:
            clients = list(self._clients)
        for c in clients:
            self.send(c, text)

    @property
    def n_clients(self) -> int:
        with self._lock:
            return len(self._clients)
