"""The actor fleet's socket transport in the PyTorch port
(``sheeprl_tpu_torch/fleet/net.py``), held to the JAX package's:

* the wire codec's frames (hello, data, any typed frame) are the JAX
  package's bytes, and each package's decoder reads the other's stream;
* a torn read costs exactly the damaged frame: a mid-frame truncation or an
  in-flight byte flip (in the payload or in the length field) is skipped
  by scanning to the next valid CRC boundary and every clean frame behind
  it survives;
* learner-side dedup is ``(incarnation, seq)``-exact: a replayed frame is
  dropped exactly once and counted, and a frame whose predecessor was lost
  is never delivered out of FIFO order (a RESEND asks for the gap);
* a real reconnect over loopback replays unacked frames and the learner
  takes each packet once; an unauthenticated HELLO is never unpickled; a
  bad token is refused and the worker stops retrying; a remote worker
  that dials with incarnation -1 gets the run spec and the slot's
  incarnation, and ``python -m sheeprl_tpu_torch.fleet.remote`` with a bad
  token exits 2;
* the drain budget and the transport come from the config.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import sheeprl_tpu.fleet.net as jax_net
from sheeprl_tpu.fleet.protocol import encode_packet as jax_encode
from sheeprl_tpu.fleet.protocol import FleetPacket as JaxPacket
from sheeprl_tpu_torch.fleet import FleetEngine, FleetPacket
from sheeprl_tpu_torch.fleet.net import (
    T_CTRL,
    T_DATA,
    T_HELLO,
    T_HELLO_ACK,
    FleetListener,
    LearnerChannel,
    NetConfig,
    NetStats,
    StreamDecoder,
    WorkerSocketChannel,
    decode_data_payload,
    encode_data_frame,
    encode_frame,
    encode_hello,
)
from sheeprl_tpu_torch.fleet.protocol import decode_packet, encode_packet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _packet_frame(seq, worker_id=0, incarnation=0, value=0.0):
    payload = ({"x": np.full((1, 1, 2), value, np.float32)}, np.zeros((1, 1), np.float32), [])
    return encode_packet(FleetPacket(worker_id, incarnation, seq, 1, 0, payload))


def test_wire_frames_are_the_jax_packages_bytes():
    payload = ({"x": np.arange(6, dtype=np.float32).reshape(1, 2, 3)}, np.ones((2, 1), np.float32), [(1.0, 2.0)])
    frame = encode_packet(FleetPacket(2, 1, 5, 2, 4, payload))
    assert frame == jax_encode(JaxPacket(2, 1, 5, 2, 4, payload))
    assert encode_data_frame(frame) == jax_net.encode_data_frame(frame)
    assert encode_hello(3, -1, "tok") == jax_net.encode_hello(3, -1, "tok")
    blob = pickle.dumps(("params", 7))
    assert encode_frame(T_CTRL, blob) == jax_net.encode_frame(jax_net.T_CTRL, blob)
    # each package's decoder reads the other's stream
    wire = encode_data_frame(frame) + jax_net.encode_frame(jax_net.T_CTRL, blob)
    for dec in (StreamDecoder(), jax_net.StreamDecoder()):
        got = dec.feed(wire)
        assert [t for t, _ in got] == [T_DATA, T_CTRL]
        assert decode_packet(decode_data_payload(got[0][1])).seq == 5


def test_codec_roundtrip_and_mid_frame_truncation_recovers_clean_frame():
    wire_a = encode_data_frame(_packet_frame(3))
    wire_b = encode_data_frame(_packet_frame(4))
    dec = StreamDecoder()
    assert dec.feed(wire_a[: len(wire_a) // 2]) == []
    frames = dec.feed(wire_b)
    assert [f[0] for f in frames] == [T_DATA]
    assert decode_packet(decode_data_payload(frames[0][1])).seq == 4
    assert dec.resyncs >= 1 and dec.skipped_bytes > 0
    # byte-for-byte split delivery (TCP fragments freely): no resync needed
    dec2 = StreamDecoder()
    got = []
    for i in range(len(wire_a)):
        got += dec2.feed(wire_a[i:i + 1])
    assert len(got) == 1 and dec2.resyncs == 0
    assert decode_packet(decode_data_payload(got[0][1])).seq == 3


@pytest.mark.parametrize("where", ["payload", "length"])
def test_codec_corrupt_frame_is_dropped_and_following_frames_survive(where):
    wire_a = bytearray(encode_data_frame(_packet_frame(7)))
    wire_b = encode_data_frame(_packet_frame(8))
    # a payload byte flipped in flight, or a byte of the length u32 (the
    # header CRC rejects it: the decoder never waits on a phantom gigabyte)
    wire_a[len(wire_a) // 2 if where == "payload" else 5] ^= 0xFF
    dec = StreamDecoder()
    frames = dec.feed(bytes(wire_a) + wire_b)
    assert [decode_packet(decode_data_payload(p)).seq for _, p in frames] == [8]


def _bare_channel(queue_depth=4):
    events = []
    return LearnerChannel(0, 0, queue_depth, NetConfig(), NetStats(), emit=events.append), events


def test_replayed_seq_is_dropped_exactly_once_and_a_gap_is_never_delivered_out_of_order():
    chan, events = _bare_channel()
    for seq in (0, 1):
        chan._on_data(encode_data_frame(_packet_frame(seq))[17:])  # the payload alone
    chan._on_data(encode_data_frame(_packet_frame(1))[17:])  # a reconnect's replay
    assert chan.pending() == 2 and chan.stats.dup_frames == 1
    assert [e["action"] for e in events if e["action"] == "dup_frame"] == ["dup_frame"]
    chan._on_data(encode_data_frame(_packet_frame(2))[17:])
    assert [decode_packet(f).seq for f in chan.drain_data()] == [0, 1, 2]
    chan._on_data(encode_data_frame(_packet_frame(3, incarnation=9))[17:])  # a stale incarnation's ghost
    assert chan.pending() == 0

    chan, events = _bare_channel()
    chan._on_data(encode_data_frame(_packet_frame(0))[17:])
    chan._on_data(encode_data_frame(_packet_frame(2))[17:])  # seq 1 lost to a resync
    assert [decode_packet(f).seq for f in chan.drain_data()] == [0]
    assert chan.stats.gap_resends == 1
    assert [e["seq"] for e in events if e["action"] == "gap_resend"] == [1]


def _recv_frames(sock, decoder, want, timeout=5.0):
    got = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            data = sock.recv(65536)
        except socket.timeout:
            continue
        if not data:
            break
        got += decoder.feed(data)
        if any(f[0] == want for f in got):
            break
    return got


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def test_reconnect_replay_over_real_sockets_is_deduped():
    listener = FleetListener(NetConfig(io_timeout_s=0.1), "tok")
    try:
        chan = listener.register(0, 0, queue_depth=8)

        def dial():
            s = socket.create_connection(("127.0.0.1", listener.port), timeout=5.0)
            s.settimeout(0.1)
            s.sendall(encode_hello(0, 0, "tok"))
            assert any(f[0] == T_HELLO_ACK for f in _recv_frames(s, StreamDecoder(), T_HELLO_ACK))
            return s

        s = dial()
        for seq in (0, 1):
            s.sendall(encode_data_frame(_packet_frame(seq)))
        assert _wait(lambda: chan.pending() == 2)
        s.close()
        s = dial()  # a worker that never saw its acks replays everything
        for seq in (0, 1, 2):
            s.sendall(encode_data_frame(_packet_frame(seq)))
        assert _wait(lambda: chan.pending() == 3)
        assert [decode_packet(f).seq for f in chan.drain_data()] == [0, 1, 2]
        assert listener.stats.dup_frames == 2 and listener.stats.reconnects == 1
        s.close()
    finally:
        listener.close()


def test_hello_from_unauthenticated_peer_is_never_unpickled(tmp_path):
    tripwire = tmp_path / "pwned"

    class Evil:
        def __reduce__(self):
            return (open, (str(tripwire), "w"))

    listener = FleetListener(NetConfig(io_timeout_s=0.1, hello_timeout_s=0.4), "tok")
    try:
        listener.register(0, 0, queue_depth=2)
        s = socket.create_connection(("127.0.0.1", listener.port), timeout=5.0)
        s.settimeout(0.1)
        s.sendall(encode_frame(T_HELLO, pickle.dumps(Evil())))
        time.sleep(0.8)
        assert not tripwire.exists()
        s.close()
    finally:
        listener.close()


def test_listener_refuses_a_bad_token_and_a_remote_attach_gets_the_spec():
    net = NetConfig(io_timeout_s=0.1)
    listener = FleetListener(net, "tok")
    try:
        listener.register(0, 0, queue_depth=2)
        events = []
        w = WorkerSocketChannel("127.0.0.1", listener.port, 0, 0, "WRONG", net=net, emit=events.append)
        assert _wait(w.stop.is_set)  # a refused identity stops retrying
        assert any(e["action"] == "refused" for e in events)
        w.close()
        # the remote handshake: incarnation -1 ("assign me") gets the spec
        listener.register(3, 7, queue_depth=2, spec={"program": "m:f", "num_workers": 4})
        w = WorkerSocketChannel("127.0.0.1", listener.port, 3, -1, "tok", net=net)
        assert _wait(lambda: w.spec is not None)
        assert w.spec == {"program": "m:f", "num_workers": 4} and w.incarnation == 7
        w.close()
    finally:
        listener.close()


def test_remote_worker_entry_exits_2_on_a_refused_attach():
    listener = FleetListener(NetConfig(io_timeout_s=0.1), "tok")
    try:
        listener.register(1, 0, queue_depth=2, spec={"program": "m:f", "num_workers": 2})
        env = dict(os.environ, PYTHONPATH=REPO)
        proc = subprocess.run([sys.executable, "-m", "sheeprl_tpu_torch.fleet.remote", "--connect",
                               f"127.0.0.1:{listener.port}", "--worker-id", "1", "--token", "WRONG",
                               "--spec-timeout-s", "10"], env=env, capture_output=True, text=True, timeout=60)
        assert proc.returncode == 2, proc.stderr[-2000:]
        assert "attach refused" in proc.stderr
    finally:
        listener.close()


def test_shutdown_drain_budget_and_transport_come_from_config():
    from sheeprl_tpu_torch.config import Config

    cfg = Config({"seed": 0, "algo": {"fleet": {"workers": 2}},
                  "fleet": {"shutdown_drain_s": 3.5, "transport": "socket", "net": {"io_timeout_s": 0.25}}})
    eng = FleetEngine.setup(cfg, total_steps=10)
    assert eng.shutdown_drain_s == 3.5 and eng.transport == "socket" and eng.net.io_timeout_s == 0.25
