"""PyTorch port vs the JAX reference: the async serving front end
(``serving/frontend.AsyncFrontend``), the watch plane's index listeners
and ``agent/http.parse_blocking``.

- ``parse_blocking`` (and ``_dur_to_s``) equal the reference's on a table
  of query strings, errors included.
- Over a plane carried across from the reference (n = 256, K = 16, packed,
  64 ticks formed, carried with ``convert.py``): the port front end's
  NEAREST / catalog / health answers equal the port's batcher-direct
  answers exactly and the reference front end's (ids exact, rtts within
  1e-6 relative); the same writes give the same WriteResults, apply index
  and KV readback on both sides.
- Index listeners fire at every advance and at close, and stop after
  removal; ``wait_index`` keeps the floor contract, times out at its wait
  and wakes on a flip; N parked waiters cost one owned thread
  (``owned_threads() == 1``); close is idempotent and later submits raise.
- Admission parity (reject / shed_oldest) with the write batcher.
- The HTTP surface on 127.0.0.1: agent self, KV PUT / GET with
  ``X-Consul-Index``, a blocking GET woken by a flip, catalog and health.
"""

import http.client
import json
import random
import threading
import time

import numpy as np
import pytest

from consul_tpu.agent import http as jhttp
from consul_tpu.models import cluster as jcluster
from consul_tpu.serving import AsyncFrontend as JAsyncFrontend
from consul_tpu.serving import ServingPlane as JServingPlane
from consul_tpu_torch import convert
from consul_tpu_torch.agent import http as thttp
from consul_tpu_torch.models import cluster as tcluster
from consul_tpu_torch.ops import deltas as deltas_mod
from consul_tpu_torch.ops import serving as kernels
from consul_tpu_torch.serving import AsyncFrontend, ServingPlane
from consul_tpu_torch.serving.batcher import (ServingClosedError,
                                              ServingOverloadError)

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401

N = 256
RTOL = 1e-6


@pytest.mark.parametrize("q", [
    {}, {"index": "7"}, {"wait": "150ms"}, {"index": "3", "wait": "2s"},
    {"wait": "1m"}, {"wait": "0.5"}, {"index": "12", "wait": " 40ms "},
    {"index": "x"}, {"wait": "fast"}, {"index": "", "wait": "1s"}])
def test_parse_blocking_equals_reference(q):
    def run(mod, *default):
        try:
            return mod.parse_blocking(q, *default)
        except ValueError:
            return ValueError
    assert run(thttp) == run(jhttp)
    assert run(thttp, 3.0) == run(jhttp, 3.0)


def _stack(n=64, seed=3, **write_kw):
    """The port's write-attached plane over a CPU simulation, formed."""
    sim = tcluster.Simulation(tp.configs(n=n, view_degree=16)[1], seed=seed,
                              kernel="torch", device="cpu")
    plane = ServingPlane(k=8, buckets=(64,), num_services=4, device="cpu")
    sim.attach_serving(plane, writes=True, kv_slots=64, **write_kw)
    sim.run(32, chunk=32, with_metrics=False)
    return sim, plane


_REF = {}


def _ref_pair():
    """The reference's formed, write-attached stack and the port's stack
    started from its world, topology and state (carried across after the
    reference ran), once per module."""
    if not _REF:
        jcfg, tcfg = tp.configs(n=N, view_degree=16)
        jsim = jcluster.Simulation(jcfg, seed=3, layout="packed")
        jplane = JServingPlane(k=8, buckets=(64,), num_services=4)
        jsim.attach_serving(jplane, writes=True, kv_slots=64)
        jsim.run(64, chunk=32, with_metrics=False)
        tsim = tcluster.Simulation(
            tcfg, seed=0, kernel="torch", device="cpu",
            world=convert.world_from(tp.np_tree(jsim.world)),
            topo=convert.topology_from(tp.np_tree(jsim.topo)),
            state=convert.packed_state_from(tp.np_tree(jsim.state)))
        tplane = ServingPlane(k=8, buckets=(64,), num_services=4, device="cpu")
        tsim.attach_serving(tplane, writes=True, kv_slots=64)
        _REF.update(jsim=jsim, jplane=jplane, tsim=tsim, tplane=tplane)
    return _REF


def _reads(n, count, seed=7):
    rng = random.Random(seed)
    out = [(kernels.MODE_NEAREST, rng.randrange(n), -1) for _ in range(count)]
    out += [(kernels.MODE_NEAREST, rng.randrange(n), s) for s in range(4)]
    out += [(kernels.MODE_CATALOG, 0, s) for s in (-1, 0, 3)]
    out += [(kernels.MODE_HEALTH, 0, s) for s in (-1, 1, 2)]
    return out


def _assert_reads_equal(ref, got, exact):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert int(r.count) == int(g.count)
        np.testing.assert_array_equal(np.asarray(g.ids), np.asarray(r.ids))
        if exact:
            np.testing.assert_array_equal(np.asarray(g.rtts), np.asarray(r.rtts))
        else:
            np.testing.assert_allclose(np.asarray(g.rtts), np.asarray(r.rtts),
                                       rtol=RTOL)


def _through(fe, reads):
    futs = [fe.submit_read(m, s, a) for m, s, a in reads]
    return [f.result(60.0) for f in futs]


def test_reads_equal_batcher_and_reference():
    r = _ref_pair()
    reads = _reads(N, 40)
    fe, jfe = AsyncFrontend(r["tplane"]).start(), JAsyncFrontend(r["jplane"]).start()
    try:
        got, ref = _through(fe, reads), _through(jfe, reads)
        direct = r["tplane"].batcher.execute(reads)
        conv = [fe.nearest(5).result(60.0), fe.catalog_nodes(2).result(60.0),
                fe.health_nodes(-1).result(60.0)]
        jconv = [jfe.nearest(5).result(60.0), jfe.catalog_nodes(2).result(60.0),
                 jfe.health_nodes(-1).result(60.0)]
    finally:
        fe.close()
        jfe.close()
    _assert_reads_equal(direct, got, exact=True)
    _assert_reads_equal(ref, got, exact=False)
    _assert_reads_equal(jconv, conv, exact=False)
    assert fe.stats()["frontend_reads"] == len(reads) + 3


def test_writes_equal_reference():
    r = _ref_pair()
    ops = [(deltas_mod.OP_REGISTER, i, i % 4) for i in range(8)]
    ops += [(deltas_mod.OP_DEREGISTER, 9, -1)]
    out = {}
    for side, plane, sim, cls in (("t", r["tplane"], r["tsim"], AsyncFrontend),
                                  ("j", r["jplane"], r["jsim"], JAsyncFrontend)):
        fe = cls(plane).start()
        try:
            futs = [fe.submit_write(o, t, a) for o, t, a in ops]
            futs.append(fe.kv_put("parity/k", 42))
            res = [f.result(60.0) for f in futs]
        finally:
            fe.close()
        sim.publish_serving()
        row = plane.kv_get("parity/k")
        out[side] = ([(x.applied, int(x.index), x.status) for x in res],
                     int(plane.apply_index), row["Value"], row["ModifyIndex"])
    assert out["t"] == out["j"]
    assert all(a for a, _, _ in out["t"][0][:8])


def test_index_listeners_fire_and_detach():
    sim, plane = _stack()
    seen, seen2 = [], []
    plane.watch.add_index_listener(seen.append)
    plane.watch.add_index_listener(seen2.append)
    plane.writes.execute([(deltas_mod.OP_REGISTER, 1, 2)])
    sim.publish_serving()
    assert seen and seen[-1] == plane.apply_index >= 1
    plane.watch.remove_index_listener(seen2.append)
    plane.watch.remove_index_listener(seen2.append)  # absent: a no-op
    n2 = len(seen2)
    sim.run(8, chunk=8, with_metrics=False)
    assert len(seen2) == n2 and len(seen) > n2
    assert seen == sorted(seen)
    plane.watch.close()
    assert len(seen) == n2 + 2  # the chunk's flip, then the close


def test_wait_index_floor_timeout_and_wake():
    sim, plane = _stack()
    plane.writes.execute([(deltas_mod.OP_REGISTER, 0, 1)])
    sim.publish_serving()
    cur = int(plane.apply_index)
    assert cur >= 1
    fe = AsyncFrontend(plane).start()
    try:
        t0 = time.perf_counter()
        assert fe.wait_index(0, 5.0).result(30.0) == plane.watch.wait_index(0, 0.0)
        assert time.perf_counter() - t0 < 2.0
        want = cur + 10 ** 6
        t0 = time.perf_counter()
        assert fe.wait_index(want, 0.05).result(30.0) == want
        assert 0.04 < time.perf_counter() - t0 < 5.0
        parked = fe.wait_index(cur, 10.0)
        time.sleep(0.05)
        assert not parked.done()
        plane.writes.execute([(deltas_mod.OP_REGISTER, 3, 2)])
        t0 = time.perf_counter()
        sim.publish_serving()
        assert parked.result(5.0) > cur
        assert time.perf_counter() - t0 < 5.0
    finally:
        fe.close()


def test_one_owned_thread_and_close():
    sim, plane = _stack()
    unreachable = int(plane.apply_index) + 10 ** 6
    before = threading.active_count()
    fe = AsyncFrontend(plane).start()
    try:
        futs = [fe.wait_index(unreachable, 0.3) for _ in range(16)]
        time.sleep(0.1)
        assert fe.owned_threads() == 1
        assert threading.active_count() - before == 1
        assert {f.result(30.0) for f in futs} == {unreachable}
        assert fe.stats()["frontend_inflight_peak"] >= 16
    finally:
        fe.close()
    assert fe.owned_threads() == 0 and fe.closed
    with pytest.raises(ServingClosedError):
        fe.submit_read(kernels.MODE_NEAREST, 0)
    fe.close()
    # Pending work fails with ServingClosedError at close.
    fe = AsyncFrontend(plane).start()
    parked = fe.wait_index(unreachable, 30.0)
    fe.close()
    with pytest.raises(ServingClosedError):
        parked.result(5.0)


@pytest.mark.parametrize("policy", ["reject", "shed_oldest"])
def test_admission_parity(policy):
    sim, plane = _stack(max_pending=4, policy=policy)
    fe = AsyncFrontend(plane, max_wait_s=0.5).start()
    try:
        futs = [fe.submit_write(deltas_mod.OP_REGISTER, i, 0) for i in range(6)]
        outcomes = []
        for f in futs:
            try:
                outcomes.append(f.result(30.0).status)
            except ServingOverloadError:
                outcomes.append("rejected")
    finally:
        fe.close()
    if policy == "reject":
        assert outcomes == ["applied"] * 4 + ["rejected"] * 2
        assert plane.writes.rejected == 2
    else:
        assert outcomes == ["shed"] * 2 + ["applied"] * 4
        assert plane.writes.shed == 2


def test_http_surface():
    sim, plane = _stack()
    fe = AsyncFrontend(plane).start()
    try:
        host, port = fe.serve_http("127.0.0.1", 0)
        conn = http.client.HTTPConnection(host, port, timeout=10)

        def call(method, path, body=None):
            conn.request(method, path, body=body)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read()), resp.getheader(
                "X-Consul-Index")

        st, body, _ = call("GET", "/v1/agent/self")
        assert st == 200 and body["Config"]["NodeName"] == "serving-frontend"
        st, body, _ = call("PUT", "/v1/kv/http/smoke", "7")
        assert st == 200 and body is True
        sim.publish_serving()
        st, rows, idx = call("GET", "/v1/kv/http/smoke")
        assert st == 200 and rows[0]["Key"] == "http/smoke"
        assert rows[0]["Value"] == 7 and int(idx) >= 1
        # A blocking GET at the current index, woken by a flip.
        box = {}

        def blocking():
            c = http.client.HTTPConnection(host, port, timeout=10)
            c.request("GET", f"/v1/kv/http/smoke?index={idx}&wait=5s")
            r = c.getresponse()
            r.read()
            box["idx"] = int(r.getheader("X-Consul-Index"))
            c.close()

        t = threading.Thread(target=blocking)
        t.start()
        time.sleep(0.1)
        assert "idx" not in box
        plane.writes.execute([(deltas_mod.OP_REGISTER, 4, 3)])
        sim.publish_serving()
        t.join(10.0)
        assert box["idx"] > int(idx)
        st, rows, _ = call("GET", "/v1/catalog/nodes?service=3")
        direct = plane.batcher.execute([(kernels.MODE_CATALOG, 0, 3)])[0]
        assert st == 200 and [r["Node"] for r in rows] == [
            int(i) for i in direct.ids[:direct.count] if int(i) >= 0]
        st, rows, _ = call("GET", "/v1/health/service/1?near=0")
        assert st == 200 and len(rows) > 0
        st, _, _ = call("GET", "/v1/kv/missing/key")
        assert st == 404
        st, _, _ = call("GET", "/v1/nope")
        assert st == 404
        st, _, _ = call("GET", "/v1/kv/http/smoke?index=x")
        assert st == 400
        conn.close()
        assert fe.stats()["frontend_http"] >= 9
    finally:
        fe.close()
