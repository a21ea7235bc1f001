"""The port's socket journal wire protocol
(``pydcop_tpu_torch/serve/wire.py``) on the CPU, after the JAX package's
``tests/unit/test_wire.py``, case for case, and held to the JAX
package's wire:

* torn frame at the kill point, glued frames, CRC skip-and-count,
  header corruption fatal for the connection, replay-from-offset never
  double-applies, partition buffering, bounded dial retries;
* ``encode_frame`` gives the JAX package's bytes, and each side's
  ``FrameDecoder`` decodes the other's frames — torn tails, glued frames
  and CRC errors included — with the same counts;
* a port ``JournalClient`` applies exactly once against a JAX
  ``JournalHub`` over localhost across a forced disconnect, and a JAX
  client against a port hub.

Every socket and pump loop has its own deadline.
"""
import json
import socket
import struct
import threading
import time
import zlib

import pytest

from pydcop_tpu.serve import wire as jax_wire
from pydcop_tpu_torch.serve.wire import (
    MAGIC,
    FrameDecoder,
    JournalClient,
    JournalHub,
    encode_frame,
)


class TestFrameDecoder:
    def test_roundtrip_single_frame(self):
        d = FrameDecoder()
        out = d.feed(encode_frame({"a": 1}))
        assert out == [{"a": 1}]
        assert d.torn == 0

    def test_glued_frames_decode_all(self):
        d = FrameDecoder()
        blob = b"".join(encode_frame({"i": i}) for i in range(5))
        assert d.feed(blob) == [{"i": i} for i in range(5)]

    def test_partial_tail_waits_then_completes(self):
        d = FrameDecoder()
        frame = encode_frame({"x": "y"})
        assert d.feed(frame[:7]) == []
        assert d.feed(frame[7:]) == [{"x": "y"}]
        assert d.torn == 0

    def test_torn_tail_counted_on_close(self):
        """The kill -9 signature: a send cut short mid-frame."""
        d = FrameDecoder()
        frame = encode_frame({"jid": "job-000001", "evt": "complete"})
        d.feed(frame[: len(frame) - 3])
        assert d.close() == 1
        assert d.torn == 1

    def test_crc_mismatch_skips_and_counts_but_resyncs(self):
        d = FrameDecoder()
        bad = bytearray(encode_frame({"n": 1}))
        bad[-1] ^= 0xFF  # corrupt the payload, header intact
        good = encode_frame({"n": 2})
        out = d.feed(bytes(bad) + good)
        assert out == [{"n": 2}]
        assert d.torn == 1
        assert not d.dead

    def test_bad_magic_kills_decoder(self):
        d = FrameDecoder()
        blob = bytearray(encode_frame({"n": 1}))
        assert blob[:2] == MAGIC
        blob[0] ^= 0xFF
        assert d.feed(bytes(blob)) == []
        assert d.dead
        assert d.torn == 1

    def test_absurd_length_kills_decoder(self):
        d = FrameDecoder()
        header = struct.Struct("<2sII").pack(MAGIC, 1 << 30, 0)
        d.feed(header)
        assert d.dead

    def test_non_dict_payload_skipped(self):
        payload = json.dumps([1, 2]).encode()
        frame = struct.Struct("<2sII").pack(
            MAGIC, len(payload), zlib.crc32(payload) & 0xFFFFFFFF
        ) + payload
        d = FrameDecoder()
        assert d.feed(frame) == []
        assert d.torn == 1
        assert not d.dead


#: frames of every shape the fleets send
FRAMES = [
    {"a": 1},
    {"hello": {"client": "replica-0", "applied": 3}},
    {"seq": 7, "body": {"evt": "complete", "jid": "job-000007",
                        "result": {"cost": 12.5, "assignment": {"v1": 2},
                                   "cycle": 21, "status": "FINISHED"}}},
    {"ack": 42},
    {"seq": 1, "body": {"cmd": "submit", "source_file": "/x/é.yaml",
                        "deadline_s": None, "stream": False}},
]


@pytest.mark.parametrize("obj", FRAMES, ids=range(len(FRAMES)))
def test_frame_bytes_equal_the_jax_packages(obj):
    assert encode_frame(obj) == jax_wire.encode_frame(obj)


def _damaged_stream(encode):
    """Glued frames, a CRC error, a non-dict payload, then a torn tail."""
    bad = bytearray(encode({"n": 1}))
    bad[-2] ^= 0x5A
    payload = json.dumps([1]).encode()
    nondict = struct.Struct("<2sII").pack(
        MAGIC, len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload
    tail = encode({"n": 9, "evt": "complete"})
    return (b"".join(encode(f) for f in FRAMES) + bytes(bad) + nondict
            + encode({"n": 2}) + tail[:-4])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_decoders_read_each_others_streams_with_equal_counts(direction):
    encode, decoder = (
        (jax_wire.encode_frame, FrameDecoder) if direction == "jax_to_port"
        else (encode_frame, jax_wire.FrameDecoder))
    blob = _damaged_stream(encode)
    d, ref = decoder(), jax_wire.FrameDecoder()
    got = []
    for i in range(0, len(blob), 13):  # fed in chunks that split frames
        got += d.feed(blob[i:i + 13])
    want = ref.feed(blob)
    assert got == want == FRAMES + [{"n": 2}]
    assert d.torn == ref.torn == 2
    assert d.close() == ref.close() == 1
    assert d.torn == ref.torn == 3
    # header corruption kills both the same way
    bad = bytearray(encode({"n": 1}))
    bad[1] ^= 0xFF
    d, ref = decoder(), jax_wire.FrameDecoder()
    assert d.feed(bytes(bad)) == ref.feed(bytes(bad)) == []
    assert d.dead and ref.dead and d.torn == ref.torn == 1


class _Pump:
    """Background hub pump — the role the fleet supervisor plays."""

    def __init__(self, hub):
        self.hub = hub
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while not self._stop.is_set():
            self.hub.pump(0.01)

    def stop(self):
        self._stop.set()
        self._t.join(timeout=5)
        assert not self._t.is_alive()


def _hub(cls):
    records = []
    hub = cls(on_record=lambda client, body: records.append((client, body)))
    return hub, records, _Pump(hub)


@pytest.fixture
def hub_records():
    hub, records, pump = _hub(JournalHub)
    yield hub, records
    pump.stop()
    hub.stop()


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


class TestHubClient:
    def test_records_apply_in_order(self, hub_records):
        hub, records = hub_records
        cli = JournalClient(("127.0.0.1", hub.port), "r0")
        assert cli.connect()
        for i in range(4):
            cli.send({"n": i})
        assert _wait(lambda: len(records) == 4)
        assert [b["n"] for _c, b in records] == [0, 1, 2, 3]
        cli.close()

    def test_lost_ack_reconnect_never_double_applies(self, hub_records):
        """THE completion-record pin: the record reaches the hub, the
        connection dies before the client sees the ack, the client
        replays on reconnect — applied exactly once."""
        hub, records = hub_records
        cli = JournalClient(("127.0.0.1", hub.port), "r0")
        assert cli.connect()
        cli.send({"evt": "complete", "jid": "job-000007"})
        assert _wait(lambda: len(records) == 1)
        assert len(cli.ep.unacked) == 1
        cli._disconnect()
        assert cli.connect()  # handshake learns hub applied=1
        cli.send({"evt": "after"})
        assert _wait(lambda: len(records) == 2)
        events = [b.get("evt") for _c, b in records]
        assert events == ["complete", "after"]  # never twice
        assert _wait(lambda: hub.stats()["connected"] == ["r0"])
        cli.close()

    def test_torn_frame_at_kill_point_counted(self, hub_records):
        """A raw connection killed mid-frame: the hub counts the torn
        tail and applies nothing from it."""
        hub, records = hub_records
        sock = socket.create_connection(("127.0.0.1", hub.port),
                                        timeout=5)
        sock.sendall(encode_frame({"hello": {"client": "torn",
                                             "applied": 0}}))
        frame = encode_frame({"seq": 1,
                              "body": {"evt": "complete",
                                       "jid": "job-000001"}})
        sock.sendall(frame[: len(frame) - 4])
        time.sleep(0.1)
        sock.close()  # the kill point
        assert _wait(lambda: hub.stats()["torn_frames"] >= 1)
        assert records == []

    def test_head_to_client_commands_dedupe(self, hub_records):
        hub, _records = hub_records
        got = []
        cli = JournalClient(("127.0.0.1", hub.port), "r0",
                            on_record=got.append)
        assert cli.connect()
        assert _wait(lambda: hub.connected("r0"))
        hub.send("r0", {"cmd": "submit", "jid": "job-000001"})
        assert _wait(lambda: bool(cli.pump(0.05) or got))
        assert got == [{"cmd": "submit", "jid": "job-000001"}]
        # sever without the hub noticing, reconnect: the hub replays
        # its unacked suffix, the client's seq dedup drops re-sends
        cli._disconnect()
        assert cli.connect()
        hub.send("r0", {"cmd": "stats"})
        deadline = time.monotonic() + 5
        while len(got) < 2 and time.monotonic() < deadline:
            cli.pump(0.05)
        assert got == [{"cmd": "submit", "jid": "job-000001"},
                       {"cmd": "stats"}]
        cli.close()

    def test_partition_buffers_and_replays_on_heal(self, hub_records):
        hub, records = hub_records
        cli = JournalClient(("127.0.0.1", hub.port), "r0",
                            max_retries=1, backoff_base=0.01)
        assert cli.connect()
        cli.send({"n": 0})
        assert _wait(lambda: len(records) == 1)
        hub.partition("r0")
        # sends into the partition buffer client-side (the send may
        # report a live link once before TCP notices the drop)
        for i in range(1, 4):
            cli.send({"n": i})
            cli.pump(0.01)
        assert len(records) == 1
        assert "r0" in hub.stats()["partitioned"]
        hub.heal_partition("r0")
        deadline = time.monotonic() + 5
        while len(records) < 4 and time.monotonic() < deadline:
            cli.pump(0.02)
            time.sleep(0.01)
        assert [b["n"] for _c, b in records] == [0, 1, 2, 3]
        cli.close()

    def test_bounded_retry_reports_failure(self):
        # a port nothing listens on: bounded retries, then False
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
        probe.close()
        cli = JournalClient(("127.0.0.1", port), "r0",
                            max_retries=2, backoff_base=0.01)
        t0 = time.monotonic()
        assert not cli.connect()
        assert time.monotonic() - t0 < 5
        assert not cli.connected


@pytest.mark.parametrize("hub_side,client_side", [
    ("jax", "port"), ("port", "jax")])
def test_exactly_once_across_the_two_packages(hub_side, client_side):
    """A client of one package against the other's hub, over localhost:
    data frames and command frames each applied exactly once, in order,
    across a forced disconnect with an ack lost in flight."""
    hub_cls = jax_wire.JournalHub if hub_side == "jax" else JournalHub
    client_cls = (jax_wire.JournalClient if client_side == "jax"
                  else JournalClient)
    hub, records, pump = _hub(hub_cls)
    got = []
    cli = client_cls(("127.0.0.1", hub.port), "replica-0",
                     on_record=got.append)
    try:
        assert cli.connect()
        cli.send({"evt": "complete", "jid": "job-000001"})
        assert _wait(lambda: len(records) == 1)
        assert _wait(lambda: hub.connected("replica-0"))
        hub.send("replica-0", {"cmd": "submit", "jid": "job-000002"})
        deadline = time.monotonic() + 5
        while not got and time.monotonic() < deadline:
            cli.pump(0.05)
        cli.send({"evt": "complete", "jid": "job-000003"})
        assert _wait(lambda: len(records) == 2)
        assert len(cli.ep.unacked) == 1  # its ack was never read
        cli._disconnect()  # the forced disconnect
        assert cli.connect()  # replays past the hub's high-water mark
        assert _wait(lambda: hub.stats()["connected"] == ["replica-0"])
        hub.send("replica-0", {"cmd": "stop"})
        cli.send({"evt": "complete", "jid": "job-000004"})
        deadline = time.monotonic() + 5
        while (len(records) < 3 or len(got) < 2) \
                and time.monotonic() < deadline:
            cli.pump(0.05)
        assert [b["jid"] for _c, b in records] == [
            "job-000001", "job-000003", "job-000004"]
        assert got == [{"cmd": "submit", "jid": "job-000002"},
                       {"cmd": "stop"}]
    finally:
        cli.close()
        pump.stop()
        hub.stop()


def test_commands_replayed_with_the_handshake_apply_at_once(hub_records):
    """A command sent while the client is away rides the hub's handshake
    reply; the port's client applies it on reconnect, in the same read
    as the hello_ack (the JAX package's client drops such frames until
    its next reconnect; ROADMAP C)."""
    hub, _records = hub_records
    got = []
    cli = JournalClient(("127.0.0.1", hub.port), "r0",
                        on_record=got.append)
    assert cli.connect()
    assert _wait(lambda: hub.connected("r0"))
    cli._disconnect()
    hub.send("r0", {"cmd": "stats"})  # to the dead socket, or buffered
    assert cli.connect()
    deadline = time.monotonic() + 5
    while not got and time.monotonic() < deadline:
        cli.pump(0.05)
    assert got == [{"cmd": "stats"}]
    assert cli.stats()["unacked"] == 0
    cli.close()
