"""Socket journal wire protocol — length-prefixed, CRC-framed record
streams between fleet processes.

The port of the JAX package's ``serve/wire.py``, byte for byte on the
wire: a frame encoded by either package decodes in the other, and each
side's hub and client speak to the other's.  The thread-hosted fleet
(serve/fleet.py) journals through a shared directory:
every replica lives in the head's process, so ``fleet.jsonl`` appends
are plain function calls.  A *process* fleet (serve/procfleet.py) has
no shared address space — each replica is a child OS process — so its
journal records, completions and control commands cross a local TCP
socket instead.  This module is that wire, built to the same
discipline the on-disk journals follow (torn writes are skipped and
*counted*, never fatal):

* **framing** — every frame is ``magic + length + CRC32(payload)``
  followed by a JSON payload.  A ``kill -9`` mid-send leaves a torn
  tail frame: the decoder holds it pending and counts it on close.  A
  recv that glues several frames together decodes them all.  A CRC
  mismatch skips exactly that frame (the length prefix preserves
  resync) and counts it; a corrupt *header* cannot be resynced, so the
  connection is dropped (counted) and the client's replay machinery
  takes over;
* **apply-exactly-once** — every data frame carries a per-sender
  sequence number.  The receiver applies a frame only when its seq
  advances past the sender's high-water mark, acks every frame (fresh
  or duplicate), and the sender drops acked frames from its replay
  buffer.  A reconnecting sender learns the receiver's applied
  high-water mark from the handshake and replays only the unacked
  suffix — so a completion record sent just before a connection loss
  is either already applied (the replay is deduplicated) or applied
  exactly once from the replay, never twice;
* **reconnect** — :class:`JournalClient` redials with bounded retries
  and exponential backoff (the JAX package's watchdog relaunch policy),
  replaying from the negotiated offset.

Both endpoints are *pump-driven*: :meth:`JournalHub.pump` and
:meth:`JournalClient.pump` do one bounded ``select`` pass, so the
fleet's tick-driven tests stay deterministic and the threaded mode
just pumps from its supervisor loop.  The hub is crossed by the
supervisor thread (pump) and the front door (send/stats), so it owns a
lock.
"""
from __future__ import annotations

import json
import select
import socket
import struct
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

#: frame header: magic, payload length, payload CRC32
MAGIC = b"\xdc\x0b"
_HEADER = struct.Struct("<2sII")
#: refuse absurd frames — a corrupt length field must not allocate GBs
MAX_FRAME = 64 * 1024 * 1024


def encode_frame(obj: Dict[str, Any]) -> bytes:
    """One wire frame: header (magic, length, CRC32) + JSON payload."""
    payload = json.dumps(obj, sort_keys=True).encode("utf-8")
    return _HEADER.pack(
        MAGIC, len(payload), zlib.crc32(payload) & 0xFFFFFFFF
    ) + payload


class FrameDecoder:
    """Incremental frame decoder over a byte stream.

    ``feed(data)`` returns every complete, CRC-valid frame decoded
    from the accumulated buffer.  Damage taxonomy (each *counted* in
    ``torn``, mirroring the on-disk journal readers):

    * partial tail (a send cut short by a kill): stays pending;
      :meth:`close` counts it when the stream ends;
    * CRC mismatch / unparseable JSON: that frame is skipped — the
      length prefix keeps the stream in sync;
    * bad magic or absurd length (header corruption): unrecoverable —
      the decoder goes ``dead`` and the connection must be dropped
      (the sender's replay machinery re-delivers).
    """

    def __init__(self):
        self._buf = b""
        self.torn = 0
        self.dead = False

    def feed(self, data: bytes) -> List[Dict[str, Any]]:
        if self.dead:
            return []
        self._buf += data
        out: List[Dict[str, Any]] = []
        while len(self._buf) >= _HEADER.size:
            magic, length, crc = _HEADER.unpack_from(self._buf)
            if magic != MAGIC or length > MAX_FRAME:
                # header corruption: no resync possible
                self.torn += 1
                self.dead = True
                self._buf = b""
                break
            end = _HEADER.size + length
            if len(self._buf) < end:
                break  # partial frame: wait for more bytes
            payload = self._buf[_HEADER.size:end]
            self._buf = self._buf[end:]
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                self.torn += 1  # skip-and-count; stream stays in sync
                continue
            try:
                obj = json.loads(payload.decode("utf-8"))
            except ValueError:
                self.torn += 1
                continue
            if not isinstance(obj, dict):
                self.torn += 1
                continue
            out.append(obj)
        return out

    def close(self) -> int:
        """End of stream: a pending partial frame is a torn tail (the
        kill -9 signature).  Returns the frames lost (0 or 1)."""
        torn_tail = 1 if self._buf else 0
        self.torn += torn_tail
        self._buf = b""
        return torn_tail


class _Endpoint:
    """Per-peer seq/ack/replay bookkeeping — one side of the
    apply-exactly-once contract, shared by hub and client."""

    def __init__(self):
        self.out_seq = 0
        #: sent-but-unacked frames, in seq order: the replay buffer
        self.unacked: List[Tuple[int, Dict[str, Any]]] = []
        #: highest incoming seq applied (the dedup high-water mark)
        self.in_applied = 0
        self.deduped = 0
        self.replayed = 0

    def next_frame(self, body: Dict[str, Any]) -> Dict[str, Any]:
        self.out_seq += 1
        frame = {"seq": self.out_seq, "body": body}
        self.unacked.append((self.out_seq, body))
        return frame

    def take_ack(self, seq: int) -> None:
        self.unacked = [(s, b) for s, b in self.unacked if s > seq]

    def accept(self, seq: int, body: Dict[str, Any]
               ) -> Optional[Dict[str, Any]]:
        """Returns the body to apply, or None for a duplicate (already
        applied before a lost ack — the replay-from-offset pin)."""
        if seq <= self.in_applied:
            self.deduped += 1
            return None
        self.in_applied = seq
        return body

    def replay_frames(self, peer_applied: int
                      ) -> List[Dict[str, Any]]:
        """Frames to re-send after a reconnect: the peer's handshake
        names its applied high-water mark; everything at or below it
        is retroactively acked, the rest replays in order."""
        self.take_ack(peer_applied)
        frames = [{"seq": s, "body": b} for s, b in self.unacked]
        self.replayed += len(frames)
        return frames


def _send_frames(sock: socket.socket, frames: List[bytes]) -> None:
    sock.sendall(b"".join(frames))


class JournalHub:
    """The head's end of the socket journal: accepts replica
    connections, applies their framed records exactly once, acks, and
    carries head→replica command frames over the same stream.

    ``on_record(client, body)`` is called for every *newly applied*
    data frame (duplicates from a replay are deduplicated and only
    re-acked).  All socket work happens inside :meth:`pump` — the hub
    spawns no threads; callers pump from their supervisor loop or
    tick, which keeps the fleet's tests deterministic."""

    def __init__(self, on_record: Callable[[str, Dict[str, Any]], None],
                 host: str = "127.0.0.1"):
        self.on_record = on_record
        self._lock = threading.Lock()
        self._listener = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind((host, 0))
        self._listener.listen(32)
        self._listener.setblocking(False)
        self.port = self._listener.getsockname()[1]
        #: live connections: socket -> (decoder, client-or-None)
        self._conns: Dict[socket.socket,
                          Tuple[FrameDecoder, Optional[str]]] = {}
        #: per-client endpoint state — SURVIVES reconnects (that is
        #: the whole point: the dedup high-water mark must outlive the
        #: connection that carried the original frames)
        self._peers: Dict[str, _Endpoint] = {}
        self._by_client: Dict[str, socket.socket] = {}
        #: partitioned clients: name -> monotonic deadline (inf = until
        #: healed); their connections are dropped and re-dials refused
        self._partitioned: Dict[str, float] = {}
        self.torn = 0
        self.closed = False

    # -- client-facing state -------------------------------------------------

    def endpoint(self, client: str) -> _Endpoint:
        with self._lock:
            if client not in self._peers:
                self._peers[client] = _Endpoint()
            return self._peers[client]

    def connected(self, client: str) -> bool:
        with self._lock:
            return client in self._by_client

    def send(self, client: str, body: Dict[str, Any]) -> None:
        """Queue one command frame for ``client`` and transmit if its
        connection is live; otherwise it rides the replay buffer and
        goes out on the next handshake.  TCP ordering + the seq/dedup
        contract give apply-exactly-once, in order."""
        with self._lock:
            ep = self._peers.setdefault(client, _Endpoint())
            frame = ep.next_frame(body)
            sock = self._by_client.get(client)
        if sock is not None:
            try:
                _send_frames(sock, [encode_frame(frame)])
            except OSError:
                self._drop(sock)

    def partition(self, client: str,
                  duration: float = float("inf")) -> None:
        """Sever ``client``'s socket and refuse its re-dials until the
        deadline passes (the ``partition_socket`` fault): frames the
        client sends meanwhile buffer on its side and replay on the
        healed reconnect — nothing is lost, nothing double-applies."""
        now = time.monotonic()
        with self._lock:
            self._partitioned[client] = (
                now + duration if duration > 0
                and duration != float("inf") else float("inf")
            )
            sock = self._by_client.get(client)
        if sock is not None:
            self._drop(sock, count_tail=False)

    def heal_partition(self, client: str) -> None:
        with self._lock:
            self._partitioned.pop(client, None)

    # -- the pump ------------------------------------------------------------

    def pump(self, timeout: float = 0.0) -> int:
        """One bounded select pass: accept dials, read every readable
        connection, apply + ack fresh frames.  Returns the number of
        data frames applied."""
        now = time.monotonic()
        with self._lock:
            if self.closed:
                return 0
            healed = [c for c, until in self._partitioned.items()
                      if until <= now]
            for c in healed:
                del self._partitioned[c]
            socks = [self._listener] + list(self._conns)
        try:
            readable, _, _ = select.select(socks, [], [], timeout)
        except (OSError, ValueError):
            readable = []
        applied = 0
        for sock in readable:
            if sock is self._listener:
                self._accept()
                continue
            applied += self._read(sock)
        return applied

    def _accept(self) -> None:
        while True:
            try:
                conn, _addr = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            conn.setblocking(False)
            with self._lock:
                self._conns[conn] = (FrameDecoder(), None)

    def _read(self, sock: socket.socket) -> int:
        try:
            data = sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return 0
        except OSError:
            self._drop(sock)
            return 0
        if not data:
            self._drop(sock)
            return 0
        with self._lock:
            entry = self._conns.get(sock)
        if entry is None:
            return 0
        decoder, client = entry
        frames = decoder.feed(data)
        if decoder.dead:
            self._drop(sock)
            return 0
        applied = 0
        for frame in frames:
            applied += self._dispatch(sock, decoder, client, frame)
            with self._lock:
                entry = self._conns.get(sock)
            if entry is None:
                break  # dispatch dropped the connection (partition)
            client = entry[1]
        return applied

    def _dispatch(self, sock, decoder, client, frame) -> int:
        hello = frame.get("hello")
        if hello is not None:
            name = str(hello.get("client"))
            with self._lock:
                until = self._partitioned.get(name)
                refuse = until is not None and (
                    until == float("inf")
                    or until > time.monotonic()
                )
            if refuse:
                self._drop(sock, count_tail=False)
                return 0
            ep = self.endpoint(name)
            with self._lock:
                old = self._by_client.get(name)
                self._conns[sock] = (decoder, name)
                self._by_client[name] = sock
            if old is not None and old is not sock:
                self._drop(old, count_tail=False)
            # handshake reply: our applied high-water mark for this
            # client (its replay offset), then OUR unacked commands
            peer_applied = int(hello.get("applied", 0))
            out = [encode_frame(
                {"hello_ack": {"applied": ep.in_applied}}
            )]
            out += [encode_frame(f)
                    for f in ep.replay_frames(peer_applied)]
            try:
                _send_frames(sock, out)
            except OSError:
                self._drop(sock)
            return 0
        if client is None:
            return 0  # data before hello: ignore until identified
        ep = self.endpoint(client)
        ack = frame.get("ack")
        if ack is not None:
            ep.take_ack(int(ack))
            return 0
        seq = frame.get("seq")
        if seq is None:
            return 0
        body = ep.accept(int(seq), frame.get("body") or {})
        try:
            _send_frames(sock, [encode_frame({"ack": int(seq)})])
        except OSError:
            self._drop(sock)
        if body is None:
            return 0  # duplicate from a replay: acked, never re-applied
        self.on_record(client, body)
        return 1

    def _drop(self, sock: socket.socket,
              count_tail: bool = True) -> None:
        with self._lock:
            entry = self._conns.pop(sock, None)
            if entry is not None:
                decoder, client = entry
                if count_tail:
                    decoder.close()
                self.torn += decoder.torn
                if client is not None \
                        and self._by_client.get(client) is sock:
                    del self._by_client[client]
        try:
            sock.close()
        except OSError:
            pass

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "port": self.port,
                "connected": sorted(self._by_client),
                "partitioned": sorted(self._partitioned),
                "torn_frames": self.torn + sum(
                    d.torn for d, _c in self._conns.values()
                ),
                "deduped": sum(e.deduped
                               for e in self._peers.values()),
                "replayed_out": sum(e.replayed
                                    for e in self._peers.values()),
            }

    def stop(self) -> None:
        with self._lock:
            if self.closed:
                return
            self.closed = True
            socks = list(self._conns)
        for sock in socks:
            self._drop(sock, count_tail=False)
        try:
            self._listener.close()
        except OSError:
            pass


class JournalClient:
    """A replica's end of the socket journal: framed sends with a
    replay buffer, bounded-retry/backoff reconnects, and dedup of
    incoming command frames.

    ``send()`` never raises on a dead link — the frame buffers and
    replays from the negotiated offset once the link heals (bounded by
    ``max_retries`` dial attempts per :meth:`pump`; a pump that cannot
    reconnect reports ``connected == False`` and the caller decides).
    Single-owner by contract: the replica worker's main loop is the
    only caller, so no lock."""

    def __init__(self, addr: Tuple[str, int], client: str,
                 on_record: Optional[
                     Callable[[Dict[str, Any]], None]] = None,
                 max_retries: int = 5,
                 backoff_base: float = 0.05,
                 backoff_max: float = 2.0,
                 dial_timeout: float = 2.0):
        self.addr = tuple(addr)
        self.client = str(client)
        self.on_record = on_record
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.dial_timeout = float(dial_timeout)
        self.ep = _Endpoint()
        self._sock: Optional[socket.socket] = None
        self._decoder = FrameDecoder()
        self.reconnects = 0
        self.torn = 0

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def _backoff(self, attempt: int) -> float:
        """The watchdog relaunch policy's curve:
        ``min(backoff_max, backoff_base * 2**attempt)``."""
        return min(self.backoff_max,
                   self.backoff_base * (2 ** attempt))

    def connect(self) -> bool:
        """Dial with bounded retries + exponential backoff, handshake,
        and replay the unacked suffix past the hub's applied offset."""
        if self._sock is not None:
            return True
        for attempt in range(self.max_retries):
            try:
                sock = socket.create_connection(
                    self.addr, timeout=self.dial_timeout
                )
                break
            except OSError:
                time.sleep(self._backoff(attempt))
        else:
            return False
        try:
            sock.settimeout(self.dial_timeout)
            _send_frames(sock, [encode_frame({"hello": {
                "client": self.client,
                "applied": self.ep.in_applied,
            }})])
            decoder = FrameDecoder()
            after: List[Dict[str, Any]] = []
            applied = self._await_hello_ack(sock, decoder, after)
            if applied is None:
                sock.close()
                return False
            frames = [encode_frame(f)
                      for f in self.ep.replay_frames(applied)]
            if frames:
                _send_frames(sock, frames)
            sock.setblocking(False)
        except OSError:
            try:
                sock.close()
            except OSError:
                pass
            return False
        self._sock = sock
        self._decoder = decoder
        self.reconnects += 1
        # the hub's replayed commands ride the handshake reply: those
        # decoded with the hello_ack apply now (the JAX package's client
        # drops them until its next reconnect)
        for frame in after:
            self._handle(frame, sock)
        return True

    def _await_hello_ack(self, sock, decoder,
                         after: List[Dict[str, Any]]) -> Optional[int]:
        """The hub's applied offset from its handshake reply; frames
        decoded after the reply in the same read go to ``after``."""
        deadline = time.monotonic() + self.dial_timeout
        while time.monotonic() < deadline:
            try:
                data = sock.recv(1 << 16)
            except socket.timeout:
                return None
            except OSError:
                return None
            if not data:
                return None
            frames = decoder.feed(data)
            for i, frame in enumerate(frames):
                ha = frame.get("hello_ack")
                if ha is not None:
                    after.extend(frames[i + 1:])
                    return int(ha.get("applied", 0))
                self._handle(frame, sock)
            if decoder.dead:
                return None
        return None

    def send(self, body: Dict[str, Any]) -> bool:
        """Buffer + transmit one data frame.  Returns whether the
        frame went out on a live link (False = buffered for replay)."""
        frame = self.ep.next_frame(body)
        if self._sock is None and not self.connect():
            return False
        try:
            _send_frames(self._sock, [encode_frame(frame)])
            return True
        except OSError:
            self._disconnect()
            return False

    def pump(self, timeout: float = 0.0) -> int:
        """Read acks + command frames; dial if disconnected.  Returns
        the number of command bodies applied (after dedup)."""
        if self._sock is None and not self.connect():
            return 0
        try:
            readable, _, _ = select.select(
                [self._sock], [], [], timeout
            )
        except (OSError, ValueError):
            self._disconnect()
            return 0
        if not readable:
            return 0
        try:
            data = self._sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return 0
        except OSError:
            self._disconnect()
            return 0
        if not data:
            self._disconnect()
            return 0
        applied = 0
        for frame in self._decoder.feed(data):
            applied += self._handle(frame, self._sock)
        if self._decoder.dead:
            self._disconnect()
        return applied

    def _handle(self, frame: Dict[str, Any], sock) -> int:
        ack = frame.get("ack")
        if ack is not None:
            self.ep.take_ack(int(ack))
            return 0
        seq = frame.get("seq")
        if seq is None:
            return 0
        body = self.ep.accept(int(seq), frame.get("body") or {})
        try:
            _send_frames(sock, [encode_frame({"ack": int(seq)})])
        except OSError:
            self._disconnect()
        if body is None:
            return 0
        if self.on_record is not None:
            self.on_record(body)
        return 1

    def _disconnect(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self.torn += self._decoder.torn
        self._decoder = FrameDecoder()

    def close(self) -> None:
        self._disconnect()

    def stats(self) -> Dict[str, Any]:
        return {
            "connected": self.connected,
            "reconnects": self.reconnects,
            "unacked": len(self.ep.unacked),
            "deduped": self.ep.deduped,
            "replayed_out": self.ep.replayed,
            "torn_frames": self.torn + self._decoder.torn,
        }
