"""Wire protocol: memberlist-compatible framing, compression, crypto.

The reference's gossip messages are msgpack bodies behind a msgType
byte, with compound batching, LZW compression, CRC32 integrity, and
AES-GCM encryption (reference memberlist/net.go:46-59, util.go:157-275,
security.go, keyring.go). This package implements that wire format so
the framework can interoperate at the byte level — the seam SURVEY.md
§7 phase 7 describes for bridging real agents into the simulated
fabric. The LZW codec's hot path is native C++ (``wire/native/lzw.cpp``)
with a pure-Python fallback.

The port's copy of ``consul_tpu/wire``: msgpack bodies go through the
port's own encoder and decoder (``wire/_msgpack.py``), and the transport
seam (``wire/bridge.py``) runs over the port's ``Simulation`` and
``SerfSimulation``.
"""

from consul_tpu_torch.wire.codec import (  # noqa: F401
    MessageType,
    decode_message,
    decode_packet,
    encode_message,
    encode_packet,
    make_compound,
    split_compound,
)
from consul_tpu_torch.wire.keyring import Keyring  # noqa: F401
