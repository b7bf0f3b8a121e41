"""Message codec: msgType framing + msgpack bodies + packet pipeline.

The reference frames every gossip message as ``[msgType byte | msgpack
body]`` (memberlist/net.go:46-59 for the type ids, go-msgpack encodes
structs as maps keyed by Go field name), batches small messages into
compound messages (util.go:157-217: ``[compoundMsg | count | u16
lengths... | bodies...]``), optionally LZW-compresses
(util.go:221-275: a ``compress{Algo, Buf}`` body behind compressMsg),
optionally prefixes a CRC32-IEEE (net.go hasCrcMsg), and optionally
encrypts the whole packet (security.go, see keyring.py).

:func:`encode_packet`/:func:`decode_packet` run that full pipeline in
wire order — encrypt(crc(compress(compound(messages)))) — matching
``rawSendMsgPacket``/``ingestPacket`` (net.go:631-700, :299-346).

The port's copy of ``consul_tpu/wire/codec.py``: the bodies go through
the port's own msgpack encoder and decoder (``wire/_msgpack.py``), which
write and read the bytes the reference's ``msgpack`` calls do, so the
codec needs no ``msgpack`` package. The one difference: a body holding a
msgpack ext value (which memberlist never sends) raises ``ValueError``
here, where the reference's decoder returns an ``ExtType``.
"""

from __future__ import annotations

import enum
import zlib
from typing import Optional

from consul_tpu_torch.wire import _msgpack, lzw
from consul_tpu_torch.wire.keyring import (NONCE_SIZE, TAG_SIZE, VERSION_SIZE,
                                     Keyring)


class MessageType(enum.IntEnum):
    """memberlist/net.go:45-60."""

    PING = 0
    INDIRECT_PING = 1
    ACK_RESP = 2
    SUSPECT = 3
    ALIVE = 4
    DEAD = 5
    PUSH_PULL = 6
    COMPOUND = 7
    USER = 8
    COMPRESS = 9
    ENCRYPT = 10
    NACK_RESP = 11
    HAS_CRC = 12
    ERR = 13


LZW_ALGO = 0  # compressionType lzwAlgo (util.go:64)

# Struct field names per message type (Go struct fields — go-msgpack
# writes them as map keys; net.go:80-175).
_FIELDS = {
    MessageType.PING: ("SeqNo", "Node"),
    MessageType.INDIRECT_PING: ("SeqNo", "Target", "Port", "Node", "Nack"),
    MessageType.ACK_RESP: ("SeqNo", "Payload"),
    MessageType.NACK_RESP: ("SeqNo",),
    MessageType.ERR: ("Error",),
    MessageType.SUSPECT: ("Incarnation", "Node", "From"),
    MessageType.ALIVE: ("Incarnation", "Node", "Addr", "Port", "Meta", "Vsn"),
    MessageType.DEAD: ("Incarnation", "Node", "From"),
    MessageType.PUSH_PULL: ("Nodes", "UserStateLen", "Join"),
    MessageType.COMPRESS: ("Algo", "Buf"),
}


def _pack_go(obj) -> bytes:
    """msgpack bytes in hashicorp/go-msgpack's default encoding
    (``codec.MsgpackHandle{}``, WriteExt=false): struct maps carry
    their keys in ALPHABETICAL order (the codec sorts struct fields by
    encoded name — go-msgpack codec/helper.go sfi "sorted. Used when
    enc/dec struct to map"), and strings/bytes use the legacy raw
    family (fixraw / raw16 / raw32 — no str8, no bin), which
    ``msgpack.packb(obj, use_bin_type=False)`` writes and
    ``_msgpack.packb`` reproduces exactly."""
    if isinstance(obj, dict):
        obj = {k: obj[k] for k in sorted(obj)}
    return _msgpack.packb(obj)


def encode_message(mtype: MessageType, body: dict) -> bytes:
    """``[msgType | msgpack(body)]`` (net.go encode :1098-1104),
    byte-compatible with go-msgpack framing (see :func:`_pack_go`)."""
    allowed = _FIELDS.get(MessageType(mtype))
    if allowed is not None:
        unknown = set(body) - set(allowed)
        if unknown:
            raise ValueError(f"unknown fields for {mtype!r}: {sorted(unknown)}")
    return bytes([mtype]) + _pack_go(body)


def as_bytes(field) -> bytes:
    """Recover raw bytes from a decoded legacy-raw field: the decoder
    maps old-format raw to str via surrogateescape (see
    :func:`decode_message`); the same handler inverts losslessly."""
    if isinstance(field, str):
        return field.encode("utf-8", "surrogateescape")
    return bytes(field)


def decode_message(buf: bytes) -> tuple[MessageType, dict]:
    if not buf:
        raise ValueError("empty message")
    if buf[0] == MessageType.USER:
        # User messages are opaque to memberlist ([userMsg | raw],
        # net.go handleUser hands the raw bytes to the delegate);
        # serf's envelope inside is decoded by the consumer
        # (decode_serf_message).
        return MessageType.USER, {"Raw": buf[1:]}
    # Legacy-raw fields (Addr, Meta, Payload) hold arbitrary bytes that
    # are not necessarily UTF-8; surrogateescape keeps them lossless
    # (re-encode with the same handler to recover the bytes).
    return MessageType(buf[0]), _msgpack.unpackb(buf[1:])


# ----------------------------------------------------------------------
# Serf envelope: serf rides memberlist user messages as
# [userMsg | serf messageType byte | msgpack body]
# (serf/delegate.go NotifyMsg dispatches on the first byte;
# serf/messages.go:10-25 type ids).
# ----------------------------------------------------------------------

SERF_LEAVE = 0
SERF_JOIN = 1
SERF_PUSH_PULL = 2
SERF_USER_EVENT = 3
SERF_QUERY = 4
SERF_QUERY_RESPONSE = 5


def encode_serf_message(serf_type: int, body: dict) -> bytes:
    """One serf message ready for Transport.WriteTo: the memberlist
    user envelope around the serf type byte + go-msgpack body."""
    return bytes([MessageType.USER, serf_type]) + _pack_go(body)


def decode_serf_message(raw) -> tuple[int, dict]:
    """Inverse of :func:`encode_serf_message` given a USER message's
    Raw bytes (str via surrogateescape accepted)."""
    raw = as_bytes(raw)
    if not raw:
        raise ValueError("empty serf message")
    try:
        body = _msgpack.unpackb(raw[1:])
    except ValueError as e:
        raise ValueError(f"malformed serf message: {e!r}") from e
    if not isinstance(body, dict):
        raise ValueError("serf message body must be a map")
    return raw[0], body


# ----------------------------------------------------------------------
# Compound batching (util.go:157-217)
# ----------------------------------------------------------------------

def make_compound(msgs: list[bytes]) -> bytes:
    if len(msgs) > 255:
        raise ValueError("compound messages hold at most 255 parts")
    out = bytearray([MessageType.COMPOUND, len(msgs)])
    for m in msgs:
        if len(m) > 0xFFFF:
            raise ValueError("compound part exceeds u16 length")
        out += len(m).to_bytes(2, "big")
    for m in msgs:
        out += m
    return bytes(out)


def split_compound(buf: bytes) -> list[bytes]:
    """decodeCompoundMessage (util.go:181-217); ``buf`` excludes the
    leading compoundMsg byte. Truncated parts raise."""
    if not buf:
        raise ValueError("missing compound length byte")
    n_parts, buf = buf[0], buf[1:]
    if len(buf) < n_parts * 2:
        raise ValueError("truncated compound length slice")
    lengths = [int.from_bytes(buf[i * 2:i * 2 + 2], "big")
               for i in range(n_parts)]
    buf = buf[n_parts * 2:]
    parts = []
    for ln in lengths:
        if len(buf) < ln:
            raise ValueError(
                f"compound truncated ({len(parts)} of {n_parts} parts)"
            )
        parts.append(buf[:ln])
        buf = buf[ln:]
    return parts


# ----------------------------------------------------------------------
# Full packet pipeline (rawSendMsgPacket/ingestPacket order)
# ----------------------------------------------------------------------

def encode_packet(msgs: list[bytes], *, compress: bool = False,
                  crc: bool = False,
                  keyring: Optional[Keyring] = None) -> bytes:
    """Sender pipeline (net.go:631-714 rawSendMsgPacket): compound when
    multiple messages, then compress, then CRC, then encrypt. The
    encrypted payload is sent RAW — no msgType prefix, no AAD
    (net.go:697-708); the receiver knows to decrypt from its own
    config, not from the bytes. (The encryptMsg byte exists only on the
    *stream* path — see :func:`encode_stream_frame`.)"""
    pkt = msgs[0] if len(msgs) == 1 else make_compound(msgs)
    if compress:
        body = _pack_go({"Algo": LZW_ALGO, "Buf": lzw.compress(pkt)})
        pkt = bytes([MessageType.COMPRESS]) + body
    if crc:
        digest = zlib.crc32(pkt) & 0xFFFFFFFF
        pkt = bytes([MessageType.HAS_CRC]) + digest.to_bytes(4, "big") + pkt
    if keyring is not None and keyring.primary is not None:
        pkt = keyring.encrypt(pkt)
    return pkt


def decode_packet(pkt: bytes,
                  keyring: Optional[Keyring] = None, *,
                  verify_incoming: bool = True) -> list[tuple[MessageType, dict]]:
    """Receiver pipeline (ingestPacket net.go:310-346 + handleCompound):
    decrypt (by config — the packet carries no encryption marker), verify
    CRC, decompress, split compounds, decode each body. Returns
    (type, body) pairs in arrival order.

    ``verify_incoming=False`` mirrors GossipVerifyIncoming=false
    (net.go:315-321): a payload no key decrypts is processed as
    plaintext instead of rejected (the key-rotation upgrade window).
    """
    if not pkt:
        raise ValueError("empty packet")
    if keyring is not None and keyring.primary is not None:
        try:
            pkt = keyring.decrypt(pkt)
        except ValueError:
            if verify_incoming:
                raise
            # fall through: treat as plaintext
    if pkt and pkt[0] == MessageType.HAS_CRC:
        if len(pkt) < 5:
            raise ValueError("truncated CRC header")
        want = int.from_bytes(pkt[1:5], "big")
        pkt = pkt[5:]
        got = zlib.crc32(pkt) & 0xFFFFFFFF
        if got != want:
            raise ValueError(f"packet CRC mismatch ({got:#x} != {want:#x})")
    if pkt and pkt[0] == MessageType.COMPRESS:
        body = _msgpack.unpackb(pkt[1:])
        if body["Algo"] != LZW_ALGO:
            raise ValueError(f"unknown compression algo {body['Algo']}")
        pkt = lzw.decompress(as_bytes(body["Buf"]))
    if pkt and pkt[0] == MessageType.COMPOUND:
        return [decode_message(part) for part in split_compound(pkt[1:])]
    return [decode_message(pkt)]


# ----------------------------------------------------------------------
# Push-pull stream payload (net.go:818-860 sendLocalState): the
# pushPullMsg type byte, a pushPullHeader, then one pushNodeState body
# per node, then the raw user state — a *sequence* of msgpack objects,
# not a single nested document.
# ----------------------------------------------------------------------

def encode_push_pull(states: list[dict], user_state: bytes = b"",
                     join: bool = False) -> bytes:
    out = bytearray([MessageType.PUSH_PULL])
    out += _pack_go(
        {"Nodes": len(states), "UserStateLen": len(user_state),
         "Join": join})
    for s in states:
        out += _pack_go(s)
    out += user_state
    return bytes(out)


def decode_push_pull(buf: bytes) -> tuple[dict, list[dict], bytes]:
    """readRemoteState (net.go:995-1035): returns (header, states,
    user_state). Any malformation — truncation, wrong shapes, bad
    msgpack — raises ValueError, so stream handlers need one guard."""
    if not buf or buf[0] != MessageType.PUSH_PULL:
        raise ValueError("not a pushPull stream")
    try:
        unpacker = _msgpack.Unpacker()
        unpacker.feed(buf[1:])
        header = unpacker.unpack()
        states = [unpacker.unpack() for _ in range(int(header["Nodes"]))]
        tail = bytes(buf[1 + unpacker.tell():])
        if len(tail) < header["UserStateLen"]:
            raise ValueError("truncated push-pull user state")
        return header, states, tail[:header["UserStateLen"]]
    except ValueError:
        raise
    except (TypeError, KeyError) as e:
        raise ValueError(f"malformed push-pull stream: {e!r}") from e


# ----------------------------------------------------------------------
# Stream (push-pull / TCP) encryption framing. Unlike the packet path,
# streams DO carry an explicit encryptMsg header:
#   [encryptMsg byte | u32 big-endian ciphertext length | ciphertext]
# with the 5 header bytes as AAD (net.go:878-900 encryptLocalState,
# :946-976 readRemoteState).
# ----------------------------------------------------------------------

def encode_stream_frame(buf: bytes, keyring: Optional[Keyring]) -> bytes:
    """encryptLocalState (net.go:878-900); plaintext passthrough when
    encryption is off (sendLocalState writes the raw stream)."""
    if keyring is None or keyring.primary is None:
        return buf
    # AES-GCM ciphertext length is deterministic (version + nonce +
    # plaintext + tag — the reference's encryptedLength, security.go),
    # so the header the AAD commits to is computable up front.
    ct_len = VERSION_SIZE + NONCE_SIZE + len(buf) + TAG_SIZE
    header = bytes([MessageType.ENCRYPT]) + ct_len.to_bytes(4, "big")
    ct = keyring.encrypt(buf, aad=header)
    assert len(ct) == ct_len
    return header + ct


def decode_stream_frame(frame: bytes, keyring: Optional[Keyring]) -> bytes:
    """decryptRemoteState (net.go:903-976): enforce the encryption
    expectation both ways, verify the header as AAD, decrypt."""
    encrypted = bool(frame) and frame[0] == MessageType.ENCRYPT
    enabled = keyring is not None and keyring.primary is not None
    if encrypted and not enabled:
        raise ValueError(
            "remote state is encrypted and encryption is not configured"
        )
    if not encrypted:
        if enabled:
            raise ValueError(
                "encryption is configured but remote state is not encrypted"
            )
        return frame
    if len(frame) < 5:
        raise ValueError("truncated stream encryption header")
    want_len = int.from_bytes(frame[1:5], "big")
    ct = frame[5:]
    if len(ct) != want_len:
        raise ValueError(
            f"stream ciphertext length {len(ct)} != header {want_len}"
        )
    return keyring.decrypt(ct, aad=frame[:5])
