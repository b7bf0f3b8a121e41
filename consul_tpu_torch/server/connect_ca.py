"""Connect CA: certificate authority for service identities.

The port's copy of ``consul_tpu/server/connect_ca.py``; it imports nothing of the reference package.

Mirrors the reference's built-in Consul CA provider (reference
agent/consul/connect_ca_endpoint.go + agent/connect/ca/
provider_consul.go + agent/connect/spiffe.go): an EC P-256 root
certificate per cluster with a SPIFFE trust-domain URI SAN, leaf
certificates for services carrying ``spiffe://<trust-domain>/ns/
default/dc/<dc>/svc/<service>`` identities, and root rotation through
the CA configuration endpoint.

Crypto is real (the ``cryptography`` package): generated certs verify
with any X.509 stack. Division of labor mirrors the raft rules the
reference follows — key/cert GENERATION happens at the endpoint
(once, like pre-assigned session ids: an FSM must never generate
randomness), and the raft log carries the finished PEM material so
every replica stores identical roots.

Simplifications vs the reference, documented: rotation activates the
new root immediately without the cross-signing intermediate window,
and leaf private keys are generated server-side (the reference's
agent generates a CSR locally; the wire trust boundary is the same
HTTPS hop either way here).
"""

from __future__ import annotations

import datetime
import hashlib
import uuid
from typing import Optional

# Optional dependency: server/endpoints.py imports this module lazily,
# and a crypto-less environment must still collect/serve everything
# except the Connect CA itself (HAVE_CRYPTOGRAPHY gates; every cert
# operation below raises RuntimeError when it is missing).
try:
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID
    HAVE_CRYPTOGRAPHY = True
except ImportError:  # pragma: no cover — crypto-less environment
    HAVE_CRYPTOGRAPHY = False
    x509 = hashes = serialization = ec = NameOID = None

DEFAULT_ROOT_TTL_S = 10 * 365 * 24 * 3600.0   # reference: 10 years
DEFAULT_LEAF_TTL_S = 72 * 3600.0              # reference: 72h


def _require_crypto():
    if not HAVE_CRYPTOGRAPHY:
        raise RuntimeError(
            "the Connect CA requires the 'cryptography' package")


def trust_domain(cluster_id: str) -> str:
    return f"{cluster_id}.consul"


def _key_pem(key) -> str:
    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    ).decode()


def _cert_pem(cert) -> str:
    return cert.public_bytes(serialization.Encoding.PEM).decode()


def generate_root(cluster_id: str,
                  ttl_s: float = DEFAULT_ROOT_TTL_S) -> dict:
    """A self-signed EC P-256 root with the SPIFFE trust-domain URI
    SAN (provider_consul.go GenerateRoot)."""
    _require_crypto()
    td = trust_domain(cluster_id)
    key = ec.generate_private_key(ec.SECP256R1())
    now = datetime.datetime.now(datetime.timezone.utc)
    name = x509.Name([x509.NameAttribute(
        NameOID.COMMON_NAME, f"Consul CA {td}")])
    cert = (
        x509.CertificateBuilder()
        .subject_name(name).issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(seconds=ttl_s))
        .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                       critical=True)
        .add_extension(x509.KeyUsage(
            digital_signature=True, key_cert_sign=True, crl_sign=True,
            content_commitment=False, key_encipherment=False,
            data_encipherment=False, key_agreement=False,
            encipher_only=False, decipher_only=False), critical=True)
        .add_extension(x509.SubjectAlternativeName(
            [x509.UniformResourceIdentifier(f"spiffe://{td}")]),
            critical=False)
        .sign(key, hashes.SHA256())
    )
    cert_pem = _cert_pem(cert)
    return {
        "id": root_id(cert_pem),
        "name": f"Consul CA Root Cert",
        "root_cert": cert_pem,
        "private_key": _key_pem(key),
        "trust_domain": td,
        "serial_number": cert.serial_number,
        "not_after": cert.not_valid_after_utc.isoformat(),
    }


def root_id(cert_pem: str) -> str:
    """Stable root identifier (the reference hashes the cert)."""
    return hashlib.sha256(cert_pem.encode()).hexdigest()[:32]


def spiffe_id(td: str, dc: str, service: str) -> str:
    return f"spiffe://{td}/ns/default/dc/{dc}/svc/{service}"


def sign_leaf(root: dict, service: str, dc: str,
              ttl_s: float = DEFAULT_LEAF_TTL_S) -> dict:
    """Mint a leaf for ``service`` signed by ``root`` (the Sign RPC +
    the agent leaf endpoint, connect_ca_endpoint.go Sign)."""
    _require_crypto()
    ca_key = serialization.load_pem_private_key(
        root["private_key"].encode(), password=None)
    ca_cert = x509.load_pem_x509_certificate(root["root_cert"].encode())
    key = ec.generate_private_key(ec.SECP256R1())
    now = datetime.datetime.now(datetime.timezone.utc)
    uri = spiffe_id(root["trust_domain"], dc, service)
    cert = (
        x509.CertificateBuilder()
        .subject_name(x509.Name([x509.NameAttribute(
            NameOID.COMMON_NAME, service)]))
        .issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(seconds=ttl_s))
        .add_extension(x509.BasicConstraints(ca=False, path_length=None),
                       critical=True)
        .add_extension(x509.KeyUsage(
            digital_signature=True, key_encipherment=True,
            key_cert_sign=False, crl_sign=False,
            content_commitment=False, data_encipherment=False,
            key_agreement=False, encipher_only=False,
            decipher_only=False), critical=True)
        .add_extension(x509.ExtendedKeyUsage(
            [x509.ExtendedKeyUsageOID.CLIENT_AUTH,
             x509.ExtendedKeyUsageOID.SERVER_AUTH]), critical=False)
        .add_extension(x509.SubjectAlternativeName(
            [x509.UniformResourceIdentifier(uri)]), critical=False)
        .sign(ca_key, hashes.SHA256())
    )
    return {
        "serial_number": format(cert.serial_number, "x"),
        "cert_pem": _cert_pem(cert),
        "private_key_pem": _key_pem(key),
        "service": service,
        "spiffe_id": uri,
        "valid_after": cert.not_valid_before_utc.isoformat(),
        "valid_before": cert.not_valid_after_utc.isoformat(),
        "root_id": root["id"],
    }


def verify_leaf(leaf_cert_pem: str, root_cert_pem: str) -> bool:
    """Does the leaf chain to the root? (test/diagnostic helper)."""
    _require_crypto()
    leaf = x509.load_pem_x509_certificate(leaf_cert_pem.encode())
    root = x509.load_pem_x509_certificate(root_cert_pem.encode())
    try:
        leaf.verify_directly_issued_by(root)
        return True
    except Exception:  # noqa: BLE001 — any failure = not verified
        return False


def new_cluster_id() -> str:
    return str(uuid.uuid4())
