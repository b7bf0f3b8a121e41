"""Run a reference test's flow against the reference's server tier and
against the port's, and compare every answer.

The port's control-plane modules (``consul_tpu_torch/server``,
``consul_tpu_torch/utils/{hcl,health}``) are copies of the reference's.
Their parity tests reuse the reference's own test functions as the script:
:func:`transcript` runs one of them once as written and once with the
reference's modules swapped for the port's (in ``sys.modules``, in their
packages and in the test module's globals), recording every call of a
public function or method of the modules under test with its arguments
and its answer, or the exception it raised. The two transcripts must be
equal, and the reference test's own assertions hold on both sides.

The reference draws ``uuid.uuid4()`` for session, token, policy,
intention, query and CA ids: both runs draw them from one seeded
sequence, so equal scripts issue equal ids. Certificates carry fresh keys
and the time they were signed: they are compared by subject, issuer, SAN
URIs and CA flag, and every private key by its kind.
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
import math
import random
import re
import sys
import threading
import types
import uuid

# reference module -> the port's copy
MODULES = {
    "consul_tpu.utils.hcl": "consul_tpu_torch.utils.hcl",
    "consul_tpu.utils.health": "consul_tpu_torch.utils.health",
    "consul_tpu.utils.telemetry": "consul_tpu_torch.utils.telemetry",
    "consul_tpu.server.acl": "consul_tpu_torch.server.acl",
    "consul_tpu.server.connect_ca": "consul_tpu_torch.server.connect_ca",
    "consul_tpu.server.discovery_chain":
        "consul_tpu_torch.server.discovery_chain",
    "consul_tpu.server.prepared_query":
        "consul_tpu_torch.server.prepared_query",
    "consul_tpu.server.autopilot": "consul_tpu_torch.server.autopilot",
    "consul_tpu.server.endpoints": "consul_tpu_torch.server.endpoints",
    "consul_tpu.server.leader": "consul_tpu_torch.server.leader",
    "consul_tpu.server.serf_plumbing": "consul_tpu_torch.server.serf_plumbing",
    "consul_tpu.server.raft": "consul_tpu_torch.server.raft",
    "consul_tpu.server.raft_store": "consul_tpu_torch.server.raft_store",
    "consul_tpu.server.fsm": "consul_tpu_torch.server.fsm",
    "consul_tpu.server.state_store": "consul_tpu_torch.server.state_store",
    "consul_tpu.server.rtt": "consul_tpu_torch.server.rtt",
    "consul_tpu.server.router": "consul_tpu_torch.server.router",
}

# The modules whose public calls are recorded (this slice's).
RECORDED = (
    "utils.hcl", "utils.health", "server.acl", "server.connect_ca",
    "server.discovery_chain", "server.prepared_query", "server.autopilot",
    "server.endpoints", "server.leader", "server.serf_plumbing",
)

# Methods whose answers are objects of the harness, not data of the
# protocol: their answers are recorded by class name only.
_UNRECORDED = {"step", "wait_converged", "leader_server", "any_follower"}


def _module(name):
    return importlib.import_module(name)


def _seeded_uuid4(seed):
    rng = random.Random(seed)
    return lambda: uuid.UUID(int=rng.getrandbits(128), version=4)


def _pem_summary(text: str):
    """A PEM block by what it says: a certificate's subject, issuer,
    SAN URIs and CA flag; a key by its kind."""
    if "PRIVATE KEY" in text.split("\n", 1)[0]:
        return ("private-key",)
    try:
        from cryptography import x509
    except ImportError:
        return ("pem",)
    cert = x509.load_pem_x509_certificate(text.encode())
    try:
        uris = sorted(cert.extensions.get_extension_for_class(
            x509.SubjectAlternativeName).value.get_values_for_type(
                x509.UniformResourceIdentifier))
    except x509.ExtensionNotFound:
        uris = []
    try:
        is_ca = cert.extensions.get_extension_for_class(
            x509.BasicConstraints).value.ca
    except x509.ExtensionNotFound:
        is_ca = None
    return ("cert", cert.subject.rfc4514_string(),
            cert.issuer.rfc4514_string(), uris, is_ca)


def plain(x, depth=0):
    """A comparable copy of an answer: containers as lists and dicts,
    floats exact (NaN as a word), PEM by :func:`_pem_summary`, objects of
    the modules under test by their class name and fields."""
    if depth > 12:
        return "..."
    if x is None or isinstance(x, (bool, int, bytes)):
        return x
    if isinstance(x, float):
        return "nan" if math.isnan(x) else x
    if isinstance(x, str):
        if x.startswith("-----BEGIN"):
            return _pem_summary(x)
        return x
    if isinstance(x, dict):
        return {plain(k, depth + 1): plain(v, depth + 1) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v, depth + 1) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted((plain(v, depth + 1) for v in x), key=repr)
    if isinstance(x, BaseException):
        return ("raise", type(x).__name__, str(x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, plain(dataclasses.asdict(x), depth + 1))
    return ("object", type(x).__name__)


def _record(log, qual, fn, method, foreign):
    def wrapped(*args, **kwargs):
        if threading.current_thread() in foreign:
            # A thread that was running before the flow began (another
            # test's) is not part of this flow's transcript.
            return fn(*args, **kwargs)
        entry = [qual, plain(args[1:] if method else args), plain(kwargs)]
        log.append(entry)
        try:
            out = fn(*args, **kwargs)
        except BaseException as e:
            entry.append(plain(e))
            raise
        entry.append(("object", type(out).__name__)
                     if qual.rsplit(".", 1)[-1] in _UNRECORDED else plain(out))
        return out

    wrapped.__wrapped__ = fn
    return wrapped


def _instrument(monkeypatch, mod, log, foreign=frozenset()):
    """Wrap every public function and method defined in ``mod``; calls
    made on a thread of ``foreign`` pass through unrecorded."""
    for name, obj in list(vars(mod).items()):
        if name.startswith("_"):
            continue
        if inspect.isfunction(obj) and obj.__module__ == mod.__name__:
            monkeypatch.setattr(mod, name,
                                _record(log, name, obj, False, foreign))
        elif inspect.isclass(obj) and obj.__module__ == mod.__name__:
            for mname, m in list(vars(obj).items()):
                if mname.startswith("_") or not inspect.isfunction(m):
                    continue
                monkeypatch.setattr(obj, mname, _record(
                    log, f"{name}.{mname}", m, True, foreign))


def _swap_in_port(monkeypatch):
    """Point the reference's module names and their packages' attributes
    at the port's copies (for the imports a test makes in its body)."""
    for ref, port in MODULES.items():
        monkeypatch.setitem(sys.modules, ref, _module(port))
        pkg, leaf = ref.rsplit(".", 1)
        monkeypatch.setattr(_module(pkg), leaf, _module(port))


def _rebind(monkeypatch, test_mod, side):
    """Point the test module's globals that name a module of
    :data:`MODULES`, or a class or function of one, at ``side``'s module
    as it now is (its public functions wrapped by :func:`_instrument`)."""
    target = {ref: _module(ref if side == "reference" else port)
              for ref, port in MODULES.items()}
    target.update({port: target[ref] for ref, port in MODULES.items()})
    for name, val in list(vars(test_mod).items()):
        if isinstance(val, types.ModuleType) and val.__name__ in target:
            monkeypatch.setattr(test_mod, name, target[val.__name__])
        elif getattr(val, "__module__", None) in target and (
                inspect.isclass(val) or inspect.isfunction(val)):
            mod = target[val.__module__]
            monkeypatch.setattr(test_mod, name, getattr(mod, val.__name__))


def fixture_value(test_mod, name):
    """The value of a function-scoped fixture of a reference test module,
    built by calling its function (it builds a fresh ServerCluster)."""
    fn = getattr(test_mod, name)
    fn = getattr(fn, "_get_wrapped_function", lambda: fn.__wrapped__)()
    return fn()


def transcript(monkeypatch, test_mod, func, side, fixtures=(), seed=0,
               instance=None, **kw):
    """Run ``func`` (a test function of ``test_mod``, or a method of
    ``instance``) on ``side`` ("reference" or "port") and return the
    recorded calls. ``fixtures`` names the module's fixtures it takes."""
    log = []
    me = threading.current_thread()
    foreign = frozenset(t for t in threading.enumerate() if t is not me)
    with monkeypatch.context() as mp:
        prefix = "consul_tpu." if side == "reference" else "consul_tpu_torch."
        for leaf in RECORDED:
            _instrument(mp, _module(prefix + leaf), log, foreign)
        if side == "port":
            _swap_in_port(mp)
        _rebind(mp, test_mod, side)
        mp.setattr(uuid, "uuid4", _seeded_uuid4(seed))
        args = {f: fixture_value(test_mod, f) for f in fixtures}
        if "tmp_path" in kw:  # each side its own data directory
            kw = dict(kw, tmp_path=kw["tmp_path"] / side)
            kw["tmp_path"].mkdir()
        args.update(kw)
        target = func if instance is None else getattr(instance, func.__name__)
        target(**args)
    return log


# Answers of the Connect CA that a fresh key or the clock decides: the
# certificates' serials and validity windows.
_VOLATILE = frozenset(("serial_number", "not_after", "valid_after",
                       "valid_before"))
_HEX32 = re.compile(r"^[0-9a-f]{32}$")


def canonical(log):
    """``log`` with the CA's clock- and key-made fields blanked, every
    root id (32 hex digits, a hash of a fresh certificate) renamed to the
    order it first appeared in, and lists of roots in that order."""
    names = {}

    def walk(x):
        if isinstance(x, dict):
            return {k: ("<volatile>" if k in _VOLATILE else walk(v))
                    for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            out = [walk(v) for v in x]
            if out and all(isinstance(v, dict) and "root_cert" in v
                           for v in out):
                # The store lists roots by id, a hash of a fresh key.
                out.sort(key=lambda v: v["id"])
            return out
        if isinstance(x, str) and _HEX32.match(x):
            return names.setdefault(x, f"<root {len(names)}>")
        return x

    return walk(log)


def flows(test_mod, names):
    """``(id, module, owner class or None, function, fixture names)`` of the named
    tests of ``test_mod`` (``"TestClass.test_name"`` or ``"test_name"``)."""
    out = []
    for qual in names:
        owner, _, fname = qual.rpartition(".")
        cls = getattr(test_mod, owner) if owner else None
        fn = getattr(cls if cls else test_mod, fname)
        params = [p for p in inspect.signature(fn).parameters if p != "self"]
        out.append((f"{test_mod.__name__}::{qual}", test_mod, cls, fn,
                    params))
    return out


def assert_same(monkeypatch, test_mod, cls, func, params, tmp_path=None):
    """The reference test's flow on both sides: equal transcripts."""
    kw = {"tmp_path": tmp_path} if "tmp_path" in params else {}
    fixtures = [p for p in params if p != "tmp_path"]
    ref = transcript(monkeypatch, test_mod, func, "reference", fixtures,
                     instance=cls() if cls else None, **kw)
    port = transcript(monkeypatch, test_mod, func, "port", fixtures,
                      instance=cls() if cls else None, **kw)
    assert ref, f"{func.__qualname__}: nothing recorded"
    ref, port = canonical(ref), canonical(port)
    for i, (r, p) in enumerate(zip(ref, port)):
        assert p == r, (func.__qualname__, i, r, p)
    assert len(port) == len(ref), (func.__qualname__, len(port), len(ref),
                                   ref[len(port):][:4], port[len(ref):][:4])
    return ref
