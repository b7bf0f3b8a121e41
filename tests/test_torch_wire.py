"""PyTorch port vs the JAX reference: the wire package
(``consul_tpu_torch/wire``: keyring, LZW, codec, key manager) and the
port's own msgpack encoder and decoder (``wire/_msgpack.py``).

- every message type of ``codec._FIELDS``, compound packets, the serf
  envelope, push-pull with user state, compression, CRC and stream frames
  encode to the reference's bytes, and each side decodes the other's
  (encrypted packets and frames, whose nonces are random, cross-decrypt);
- ``_msgpack.packb`` writes ``msgpack.packb(obj, use_bin_type=False)``'s
  bytes for random trees of the subset, and ``_msgpack.unpackb`` returns
  what ``msgpack.unpackb(raw=False, unicode_errors="surrogateescape")``
  returns or raises ``ValueError`` where it raises, on random, truncated
  and hand-made inputs (str8, bin, non-str map keys, trailing bytes, the
  nesting limit); an ext type, which memberlist never sends, raises;
- the native LZW codec equals ``compress_py`` and the reference's, on
  seeded inputs past the 4,095-code reset, and its library lands in the
  kernels' build directory;
- the key manager's rotation, partial install and primary removal, as
  tests/test_protocol_gaps.py runs them.
"""

import math
import os
import struct

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from consul_tpu.wire import codec as jcodec
from consul_tpu.wire import keyring as jkeyring
from consul_tpu.wire import lzw as jlzw
from consul_tpu_torch.utils import compile_cache
from consul_tpu_torch.wire import _msgpack, codec, keymanager, keyring, lzw
from consul_tpu_torch.wire.codec import MessageType

needs_crypto = pytest.mark.skipif(
    not keyring.HAVE_CRYPTOGRAPHY,
    reason="requires the 'cryptography' package (AES-GCM)")

KEY = bytes(range(16))


def ref_unpackb(data):
    return msgpack.unpackb(data, raw=False, unicode_errors="surrogateescape")


def same(a, b) -> bool:
    """Structural equality with NaN equal to NaN and types checked
    (iterative: decoded trees nest up to 1,024 deep)."""
    todo = [(a, b)]
    while todo:
        a, b = todo.pop()
        if type(a) is not type(b):
            return False
        if isinstance(a, float):
            if not ((math.isnan(a) and math.isnan(b))
                    or struct.pack(">d", a) == struct.pack(">d", b)):
                return False
        elif isinstance(a, list):
            if len(a) != len(b):
                return False
            todo.extend(zip(a, b))
        elif isinstance(a, dict):
            if list(a) != list(b):
                return False
            todo.extend((a[k], b[k]) for k in a)
        elif a != b:
            return False
    return True


# ----------------------------------------------------------------------
# Messages, packets and frames against the reference's bytes
# ----------------------------------------------------------------------

BODIES = {
    MessageType.PING: {"SeqNo": 1, "Node": "sim-3"},
    MessageType.INDIRECT_PING: {"SeqNo": 70000, "Target": b"sim-9",
                                "Port": 7946, "Node": "sim-9", "Nack": True},
    MessageType.ACK_RESP: {"SeqNo": 300, "Payload": bytes(range(40))},
    MessageType.NACK_RESP: {"SeqNo": 5},
    MessageType.ERR: {"Error": "x" * 100},
    MessageType.SUSPECT: {"Incarnation": 7, "Node": "b", "From": "a"},
    MessageType.ALIVE: {"Incarnation": 2 ** 33, "Node": "n",
                        "Addr": bytes([10, 0, 0, 1]), "Port": 7946,
                        "Meta": b"\xff\xfe", "Vsn": bytes([1, 5, 1, 2, 5, 4])},
    MessageType.DEAD: {"Incarnation": 0, "Node": "é" * 20, "From": "q"},
    MessageType.PUSH_PULL: {"Nodes": 3, "UserStateLen": -1, "Join": False},
    MessageType.COMPRESS: {"Algo": 0, "Buf": b"\x00" * 70000},
}


def test_fields_cover_every_message_type():
    assert set(BODIES) == set(codec._FIELDS) == set(jcodec._FIELDS)
    assert codec._FIELDS == jcodec._FIELDS


@pytest.mark.parametrize("mtype", list(BODIES), ids=lambda m: m.name)
def test_message_bytes_and_cross_decode(mtype):
    body = BODIES[mtype]
    got = codec.encode_message(mtype, body)
    assert got == jcodec.encode_message(mtype, body)
    for dec in (codec.decode_message, jcodec.decode_message):
        t, b = dec(got)
        assert t == mtype
        assert same(b, codec.decode_message(got)[1])
    with pytest.raises(ValueError):
        codec.encode_message(mtype, dict(body, Bogus=1))


def test_packets_compound_compressed_crc():
    msgs = [codec.encode_message(m, BODIES[m]) for m in
            (MessageType.PING, MessageType.SUSPECT, MessageType.ALIVE)]
    for kw in ({}, {"compress": True}, {"crc": True},
               {"compress": True, "crc": True}):
        for part in (msgs[:1], msgs):
            pkt = codec.encode_packet(part, **kw)
            assert pkt == jcodec.encode_packet(part, **kw), kw
            want = jcodec.decode_packet(pkt)
            got = codec.decode_packet(pkt)
            assert [t for t, _ in got] == [t for t, _ in want]
            assert all(same(a, b) for (_, a), (_, b) in zip(got, want))
    assert codec.split_compound(codec.make_compound(msgs)[1:]) == msgs
    with pytest.raises(ValueError):
        codec.split_compound(codec.make_compound(msgs)[1:-3])
    bad = bytearray(codec.encode_packet(msgs, crc=True))
    bad[-1] ^= 1
    with pytest.raises(ValueError):
        codec.decode_packet(bytes(bad))


def test_serf_envelope_and_push_pull():
    body = {"LTime": 9, "Name": "deploy", "Payload": b"\x00v3", "CC": True}
    env = codec.encode_serf_message(codec.SERF_USER_EVENT, body)
    assert env == jcodec.encode_serf_message(codec.SERF_USER_EVENT, body)
    raw = codec.decode_message(env)[1]["Raw"]
    assert codec.decode_serf_message(raw) == jcodec.decode_serf_message(raw)
    for bad in (b"", bytes([4]), bytes([4, 0xc1]), bytes([4, 0x01]),
                bytes([4, 0x81, 0xa1, 0x61])):
        with pytest.raises(ValueError):
            codec.decode_serf_message(bad)
        with pytest.raises(ValueError):
            jcodec.decode_serf_message(bad)
    states = [{"Name": f"sim-{i}", "Addr": f"sim-{i}".encode(), "Port": 7946,
               "Meta": b"", "Incarnation": i, "State": i % 4,
               "Vsn": bytes([1, 5, 1, 2, 5, 4])} for i in range(3)]
    pp = codec.encode_push_pull(states, user_state=b"\x01user\xff", join=True)
    assert pp == jcodec.encode_push_pull(states, user_state=b"\x01user\xff",
                                         join=True)
    for dec in (codec.decode_push_pull, jcodec.decode_push_pull):
        header, got, user = dec(pp)
        assert header == {"Join": True, "Nodes": 3, "UserStateLen": 6}
        assert user == b"\x01user\xff" and len(got) == 3
    for cut in (2, len(pp) // 2, len(pp) - 1):
        for dec in (codec.decode_push_pull, jcodec.decode_push_pull):
            with pytest.raises(ValueError):
                dec(pp[:cut])
    bad_header = bytes([MessageType.PUSH_PULL]) + _msgpack.packb([1, 2])
    with pytest.raises(ValueError):
        codec.decode_push_pull(bad_header)


@needs_crypto
def test_encrypted_packets_and_stream_frames_cross_decrypt():
    ring, jring = keyring.Keyring(primary=KEY), jkeyring.Keyring(primary=KEY)
    msgs = [codec.encode_message(MessageType.NACK_RESP, {"SeqNo": 5})]
    pkt = codec.encode_packet(msgs, compress=True, crc=True, keyring=ring)
    assert pkt[0] == 1 and len(pkt) > 29
    assert jcodec.decode_packet(pkt, keyring=jring)[0][1] == {"SeqNo": 5}
    jpkt = jcodec.encode_packet(msgs, crc=True, keyring=jring)
    assert codec.decode_packet(jpkt, keyring=ring)[0][1] == {"SeqNo": 5}
    with pytest.raises(ValueError):
        codec.decode_packet(codec.encode_packet(msgs), keyring=ring)
    assert codec.decode_packet(codec.encode_packet(msgs), keyring=ring,
                               verify_incoming=False)[0][1] == {"SeqNo": 5}
    buf = codec.encode_push_pull([], b"state")
    frame = codec.encode_stream_frame(buf, ring)
    assert frame[0] == MessageType.ENCRYPT
    assert jcodec.decode_stream_frame(frame, jring) == buf
    assert codec.decode_stream_frame(
        jcodec.encode_stream_frame(buf, jring), ring) == buf
    assert codec.encode_stream_frame(buf, None) == buf
    with pytest.raises(ValueError):
        codec.decode_stream_frame(buf, ring)
    with pytest.raises(ValueError):
        codec.decode_stream_frame(frame, None)
    tampered = bytearray(frame)
    tampered[2] ^= 1
    with pytest.raises(ValueError):
        codec.decode_stream_frame(bytes(tampered), ring)


def test_keyring_without_a_key():
    ring = keyring.Keyring()
    assert ring.primary is None
    with pytest.raises(ValueError):
        ring.encrypt(b"x")
    with pytest.raises(ValueError):
        keyring.validate_key(b"short")


# ----------------------------------------------------------------------
# msgpack: the port's encoder and decoder against the package
# ----------------------------------------------------------------------

scalars = (st.none() | st.booleans()
           | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
           | st.floats(allow_nan=False) | st.text() | st.binary())
trees = st.recursive(
    scalars,
    lambda kids: (st.lists(kids, max_size=20)
                  | st.dictionaries(st.text() | st.binary(), kids,
                                    max_size=20)),
    max_leaves=60)


@settings(max_examples=100, deadline=None, derandomize=True)
@given(trees)
def test_packb_equals_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=False)
    assert _msgpack.packb(obj) == want
    assert same(_msgpack.unpackb(want), ref_unpackb(want))


def _outcome(fn, data):
    try:
        return True, fn(data)
    except ValueError:
        return False, None
    except Exception as e:  # noqa: BLE001 — msgpack's own error types
        return False, e


def assert_decoders_agree(data):
    ok_r, want = _outcome(ref_unpackb, data)
    ok_p, got = _outcome(_msgpack.unpackb, data)
    if ok_r and isinstance(want, (msgpack.ExtType, msgpack.Timestamp)):
        assert not ok_p  # ext: refused by the port
        return
    assert ok_p == ok_r, (data.hex(), want, got)
    if ok_p:
        assert same(got, want), data.hex()
    else:
        assert got is None, (data.hex(), got)  # ValueError only


@settings(max_examples=200, deadline=None, derandomize=True)
@given(st.binary(max_size=64))
def test_unpackb_random_bytes(data):
    assert_decoders_agree(data)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(trees, st.integers(min_value=0, max_value=1000))
def test_unpackb_truncated_and_extended(obj, cut):
    buf = msgpack.packb(obj, use_bin_type=False)
    assert_decoders_agree(buf[:cut % (len(buf) + 1)])
    assert_decoders_agree(buf + b"\x00")


@pytest.mark.parametrize("name,data", [
    ("str8", b"\xd9\x03abc"),
    ("str8_invalid_utf8", b"\xd9\x02\xff\xfe"),
    ("bin8", b"\xc4\x02\x00\x01"),
    ("bin16", b"\xc5\x00\x01\x07"),
    ("bin32", b"\xc6\x00\x00\x00\x01\x07"),
    ("bin_map_key", b"\x81\xc4\x01k\x01"),
    ("int_map_key", b"\x81\x01\x02"),
    ("nil_map_key", b"\x81\xc0\x02"),
    ("list_map_key", b"\x81\x91\x01\x02"),
    ("duplicate_keys", b"\x82\xa1a\x01\xa1a\x02"),
    ("trailing", b"\x01\x02"),
    ("empty", b""),
    ("reserved_c1", b"\xc1"),
    ("float32", b"\xca\x3f\xc0\x00\x00"),
    ("float32_nan", b"\xca\x7f\xc0\x00\x01"),
    ("uint64_max", b"\xcf" + b"\xff" * 8),
    ("int64_min", b"\xd3\x80" + b"\x00" * 7),
    ("array32", b"\xdd\x00\x00\x00\x01\xc3"),
    ("map16_short", b"\xde\x00\x02\xa1a\x01"),
    ("nest_1024", b"\x91" * 1024 + b"\x01"),
    ("nest_1025_empty", b"\x91" * 1024 + b"\x90"),
    ("nest_2000", b"\x91" * 2000),
    ("fixext1", b"\xd4\x01\x02"),
    ("timestamp32", b"\xd6\xff\x00\x00\x00\x01"),
    ("ext8", b"\xc7\x01\x05\x00"),
])
def test_unpackb_by_name(name, data):
    assert_decoders_agree(data)


def test_unpacker_reads_value_by_value():
    buf = _msgpack.packb({"Nodes": 1}) + _msgpack.packb([1, "a"]) + b"\xa5ab"
    up, ref = _msgpack.Unpacker(), msgpack.Unpacker(
        raw=False, unicode_errors="surrogateescape")
    up.feed(buf)
    ref.feed(buf)
    for _ in range(2):
        assert up.unpack() == ref.unpack()
        assert up.tell() == ref.tell()
    with pytest.raises(ValueError):
        up.unpack()
    with pytest.raises(msgpack.OutOfData):
        ref.unpack()


def test_packb_refuses_what_msgpack_refuses():
    for obj, exc in ((2 ** 64, OverflowError), (-2 ** 63 - 1, OverflowError),
                     (object(), TypeError), ("\udcff", UnicodeEncodeError)):
        with pytest.raises(exc):
            msgpack.packb(obj, use_bin_type=False)
        with pytest.raises(exc):
            _msgpack.packb(obj)


# ----------------------------------------------------------------------
# LZW
# ----------------------------------------------------------------------

def test_native_lzw_matches_python_and_reference():
    assert lzw.native_available()
    path = lzw.library_path()
    assert os.path.dirname(path) == compile_cache.build_dir()
    assert os.path.exists(path)
    rng = np.random.default_rng(11)
    for n, alphabet in ((0, 2), (1, 2), (300, 3), (9000, 4), (30000, 256),
                        (60000, 16)):
        data = bytes(rng.integers(0, alphabet, n).astype(np.uint8))
        want = jlzw.compress_py(data)
        assert lzw.compress_py(data) == want
        assert lzw.compress(data) == want
        assert lzw.decompress(want) == data
        assert lzw.decompress_py(want) == data
    with pytest.raises(ValueError):
        lzw.decompress(b"\xff\xff\xff")
    with pytest.raises(ValueError):
        lzw.decompress_py(want[:len(want) // 2])


# ----------------------------------------------------------------------
# Key manager (tests/test_protocol_gaps.py's cases)
# ----------------------------------------------------------------------

def _members(n=4):
    k0 = os.urandom(16)
    return k0, {f"m{i}": keyring.Keyring(primary=k0) for i in range(n)}


@needs_crypto
def test_keymanager_full_rotation():
    k0, members = _members()
    mgr = keymanager.KeyManager(members)
    k1 = os.urandom(32)
    r = mgr.install_key(k1)
    assert r.ok and r.num_resp == 4
    assert members["m3"].decrypt(members["m0"].encrypt(b"x")) == b"x"
    assert mgr.use_key(k1).ok
    assert all(ring.primary == k1 for ring in members.values())
    assert mgr.remove_key(k0).ok
    import base64
    assert mgr.list_keys().keys == {base64.b64encode(k1).decode(): 4}


def test_keymanager_partial_install_and_primary_removal():
    k0, members = _members()
    k1 = os.urandom(16)
    r = keymanager.KeyManager(
        members, reachable=lambda: {"m0", "m1", "m2"}).install_key(k1)
    assert r.num_resp == 3 and not r.ok
    r = keymanager.KeyManager(members).use_key(k1)
    assert r.num_err == 1 and "m3" in r.messages
    r = keymanager.KeyManager(members).remove_key(members["m0"].primary)
    assert r.num_err == 3 and not r.ok
