"""Gossip encryption keyring: AES-GCM with multi-key rotation (the port's
copy of ``consul_tpu/wire/keyring.py``).

Mirrors the reference (memberlist/security.go:90-156 + keyring.go):
payloads are ``[version byte | 12-byte nonce | ciphertext+tag]`` with
encryption version 1 (no padding — version 0's PKCS7 form is accepted
on decrypt); the keyring holds several installed keys with one primary
used for encryption, and decryption tries every key so clusters can
rotate keys without a flag day (serf/keymanager.go install → use →
remove).

Keys are 16/24/32 bytes (AES-128/192/256, security.go ValidateKey).
"""

from __future__ import annotations

import os
from typing import Optional

# Optional dependency: the wire package (codec framing, bridge, key
# manager) must import — and the pure-framing paths must work — on a
# box without ``cryptography``; only actually encrypting/decrypting
# requires it (HAVE_CRYPTOGRAPHY gates, RuntimeError on use).
try:
    from cryptography.exceptions import InvalidTag
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    HAVE_CRYPTOGRAPHY = True
except ImportError:  # pragma: no cover — crypto-less environment
    HAVE_CRYPTOGRAPHY = False
    AESGCM = None

    class InvalidTag(Exception):
        """Stand-in so ``except InvalidTag`` clauses keep working."""

VERSION_SIZE = 1
NONCE_SIZE = 12
TAG_SIZE = 16
MAX_ENCRYPTION_VERSION = 1


def _require_crypto():
    if not HAVE_CRYPTOGRAPHY:
        raise RuntimeError(
            "gossip encryption requires the 'cryptography' package")


def validate_key(key: bytes):
    if len(key) not in (16, 24, 32):
        raise ValueError(
            f"key size {len(key)} not 16/24/32 bytes (AES-128/192/256)"
        )


def encrypt_payload(key: bytes, msg: bytes, aad: bytes = b"",
                    version: int = 1) -> bytes:
    """security.go:90 encryptPayload (version 1: no padding)."""
    _require_crypto()
    validate_key(key)
    if version != 1:
        raise ValueError("only encryption version 1 is produced")
    nonce = os.urandom(NONCE_SIZE)
    ct = AESGCM(key).encrypt(nonce, msg, aad or None)
    return bytes([version]) + nonce + ct


def decrypt_with_key(key: bytes, payload: bytes, aad: bytes = b"") -> bytes:
    """security.go:137 decryptMessage + version handling (:158-...):
    version 0 strips PKCS7 padding after decryption."""
    _require_crypto()
    if len(payload) < VERSION_SIZE + NONCE_SIZE + TAG_SIZE:
        raise ValueError("payload too small to decrypt")
    version = payload[0]
    if version > MAX_ENCRYPTION_VERSION:
        raise ValueError(f"unsupported encryption version {version}")
    nonce = payload[VERSION_SIZE:VERSION_SIZE + NONCE_SIZE]
    ct = payload[VERSION_SIZE + NONCE_SIZE:]
    plain = AESGCM(key).decrypt(nonce, ct, aad or None)
    if version == 0 and plain:
        plain = plain[:len(plain) - plain[-1]]  # pkcs7decode
    return plain


class Keyring:
    """Multi-key ring (memberlist/keyring.go): ``keys[0]`` is the
    primary (used to encrypt); all keys are tried on decrypt."""

    def __init__(self, keys: Optional[list[bytes]] = None,
                 primary: Optional[bytes] = None):
        self._keys: list[bytes] = []
        if primary is not None:
            validate_key(primary)
            self._keys.append(primary)
        for k in keys or []:
            self.install(k)

    def install(self, key: bytes):
        validate_key(key)
        if key not in self._keys:
            self._keys.append(key)

    def use(self, key: bytes):
        """Make an installed key the primary (keyring.go UseKey)."""
        if key not in self._keys:
            raise KeyError("key is not in the keyring")
        self._keys.remove(key)
        self._keys.insert(0, key)

    def remove(self, key: bytes):
        """keyring.go RemoveKey: the primary cannot be removed."""
        if self._keys and key == self._keys[0]:
            raise ValueError("removing the primary key is not allowed")
        if key in self._keys:
            self._keys.remove(key)

    @property
    def keys(self) -> list[bytes]:
        return list(self._keys)

    @property
    def primary(self) -> Optional[bytes]:
        return self._keys[0] if self._keys else None

    def encrypt(self, msg: bytes, aad: bytes = b"") -> bytes:
        if not self._keys:
            raise ValueError("keyring is empty")
        return encrypt_payload(self._keys[0], msg, aad)

    def decrypt(self, payload: bytes, aad: bytes = b"") -> bytes:
        """Try every installed key (security.go decryptPayload loop)."""
        err: Exception = ValueError("keyring is empty")
        for key in self._keys:
            try:
                return decrypt_with_key(key, payload, aad)
            except (InvalidTag, ValueError) as e:
                err = e
        raise ValueError(f"no installed key decrypts the payload: {err}")
