"""PyTorch port vs the JAX reference: the serving plane's read side
(``consul_tpu_torch/ops/serving.py``, ``serving/{batcher,plane}.py``,
``server/rtt.py`` and ``Simulation.attach_serving``).

- ``execute`` equals the reference's ``kernel_for(k)`` on the same
  snapshot (numpy, carried across with ``convert.snapshot_from``): every
  mode, service filters and -1, k in {1, 8} and a k above the count,
  NOOP-padded batches, unknown (non-finite) coordinates, the adjustment
  clamp, a negative source (the reference's gather wraps it) and the
  tick-0 tie (every distance equal: the k lowest live ids). ids, counts
  and tick exact; rtts within relative 1e-6 (the reference may sum the
  8 squares in another order).
- ``project`` of a packed state equals ``project`` of its unpacked state
  (``torch.equal``) and the reference's ``project``.
- Host coordinates against the reference's ``server/rtt.py``, as
  ``tests/test_serving.py::TestGoldenParity`` holds the reference.
- ``Simulation`` / ``SerfSimulation`` with a plane attached (n = 64,
  CPU), as ``TestSimServing`` does for the reference; attaching a plane,
  with or without writes, leaves the state after 64 ticks equal to a run
  without one.
- ``QueryBatcher``: buckets, chunking, coalescing, close.
"""

import math
import random
import threading

import jax
import numpy as np
import pytest
import torch

from consul_tpu.agent.cache import Cache
from consul_tpu.models import layout as jlayout
from consul_tpu.ops import serving as jserving
from consul_tpu.server import rtt as jrtt
from consul_tpu_torch import convert
from consul_tpu_torch.config import SimConfig
from consul_tpu_torch.models import layout as tlayout
from consul_tpu_torch.models.cluster import SerfSimulation, Simulation
from consul_tpu_torch.ops import serving as tserving
from consul_tpu_torch.server import rtt as trtt
from consul_tpu_torch.serving import (MODE_CATALOG, MODE_DIST, MODE_HEALTH,
                                      MODE_NEAREST, MODE_NOOP, QueryBatcher,
                                      ServingClosedError, ServingPlane)

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401

RTOL = 1e-6
N, D = 64, 8


def make_snapshot(rng, n=N, d=D, tie=False, tick=37):
    """A numpy snapshot: random coordinates with two non-finite rows
    (unknown), one adjustment large and negative (the adjusted <= 0
    clamp), ~85 % live, four service labels. ``tie``: every coordinate
    at the origin, the height floor, no adjustment (a fresh simulation)."""
    if tie:
        vec = np.zeros((n, d), np.float32)
        height = np.full(n, 1e-5, np.float32)
        adj = np.zeros(n, np.float32)
    else:
        vec = rng.normal(0, 0.02, (n, d)).astype(np.float32)
        height = rng.uniform(1e-5, 0.01, n).astype(np.float32)
        adj = rng.uniform(-0.02, 0.02, n).astype(np.float32)
        adj[3] = -10.0
        vec[7, 2] = np.nan
        height[11] = np.inf
    known = np.isfinite(vec).all(-1) & np.isfinite(height) & np.isfinite(adj)
    live = rng.random(n) < 0.85
    live[:2] = False
    return jserving.Snapshot(
        vec=vec, height=height, adjustment=adj, known=known, live=live,
        service=(np.arange(n) % 4).astype(np.int32), tick=np.int32(tick))


def make_queries(rng, b, n=N, pad=4):
    """``b`` queries over every mode, then ``pad`` NOOP slots."""
    modes = [MODE_NEAREST, MODE_DIST, MODE_CATALOG, MODE_HEALTH, MODE_NOOP]
    mode = np.array([modes[i % 5] for i in range(b)] + [MODE_NOOP] * pad,
                    np.int32)
    src = rng.integers(0, n, b + pad).astype(np.int32)
    # NEAREST rows (every fifth) from a dead source, the clamped one, an
    # unknown one, and -1 (counts from the end, as the reference's gather).
    src[[0, 5, 10, 15]] = [0, 3, 7, -1]
    arg = rng.integers(-1, 4, b + pad).astype(np.int32)
    dist_rows = mode == MODE_DIST
    arg[dist_rows] = rng.integers(0, n, int(dist_rows.sum()))
    arg[np.flatnonzero(dist_rows)[:2]] = [n + 3, 11]  # out of range; unknown
    arg[b:] = -1
    return mode, src, arg


def run_both(k, snap_np, mode, src, arg):
    ref = jax.device_get(jserving.kernel_for(k)(snap_np, mode, src, arg))
    got = tserving.execute(k, convert.snapshot_from(snap_np),
                           *(torch.from_numpy(x) for x in (mode, src, arg)))
    return ref, got


def assert_results_equal(ref, got):
    r_ids, r_rtts, r_count, r_tick = (np.asarray(x) for x in ref)
    g_ids, g_rtts, g_count, g_tick = got
    np.testing.assert_array_equal(g_ids.numpy(), r_ids)
    np.testing.assert_array_equal(g_count.numpy(), r_count)
    assert int(g_tick) == int(r_tick)
    np.testing.assert_allclose(g_rtts.numpy(), r_rtts, rtol=RTOL, atol=0)


@pytest.mark.parametrize("k", [1, 8, 32])
def test_execute_matches_reference(k):
    rng = np.random.default_rng(k)
    snap = make_snapshot(rng)
    mode, src, arg = make_queries(rng, 20)
    ref, got = run_both(k, snap, mode, src, arg)
    assert_results_equal(ref, got)
    count = got[2].numpy()
    assert (count[mode == MODE_NOOP] == 0).all()
    if k == 32:
        # A service-filtered NEAREST / HEALTH answers fewer than k rows.
        assert (count[(mode == MODE_HEALTH) & (arg >= 0)] < k).all()
    ids = got[0].numpy()
    assert math.isinf(got[1].numpy()[mode == MODE_NOOP].max())
    if k >= 8:
        # The unknown source's NEAREST rows are all +inf, id order.
        row = int(np.flatnonzero((mode == MODE_NEAREST) & (src == 7))[0])
        assert np.isinf(got[1].numpy()[row, :min(k, count[row])]).all()
        assert (np.diff(ids[row, :min(k, count[row])]) > 0).all()


def test_tick_zero_tie_returns_lowest_live_ids():
    rng = np.random.default_rng(5)
    snap = make_snapshot(rng, tie=True, tick=0)
    b = 16
    mode = np.full(b, MODE_NEAREST, np.int32)
    src = rng.integers(0, N, b).astype(np.int32)
    arg = np.full(b, -1, np.int32)
    arg[8:] = 2
    ref, got = run_both(8, snap, mode, src, arg)
    assert_results_equal(ref, got)
    live = np.flatnonzero(snap.live)
    ids = got[0].numpy()
    assert (ids[:8] == live[:8]).all()
    assert (ids[8:] == live[snap.service[live] == 2][:8]).all()


def test_smallest_k_breaks_ties_to_the_lower_id():
    key = torch.tensor([[3.0, 1.0, 1.0, -0.5, 1.0, -0.5, 2.0, 1.0]])
    ids = torch.arange(8, dtype=torch.int64)
    assert tserving.smallest_k(key, ids, 6).tolist() == [[3, 5, 1, 2, 4, 7]]


def test_block_rows_bounds_the_temporaries():
    rows = tserving.block_rows(1 << 20, 8, 1024)
    assert 1 <= rows < 1024
    assert rows * (1 << 20) * tserving.temp_bytes_per_cell(8) \
        <= tserving.TEMP_BUDGET_BYTES
    assert tserving.block_rows(64, 8, 24) == 24


def test_execute_in_blocks_equals_one_block(monkeypatch):
    rng = np.random.default_rng(9)
    snap = convert.snapshot_from(make_snapshot(rng))
    q = [torch.from_numpy(x) for x in make_queries(rng, 20)]
    whole = tserving.execute(8, snap, *q)
    monkeypatch.setattr(tserving, "TEMP_BUDGET_BYTES",
                        3 * N * tserving.temp_bytes_per_cell(D))
    assert tserving.block_rows(N, D, 24) == 3
    blocks = tserving.execute(8, snap, *q)
    for a, b in zip(whole[:3], blocks[:3]):
        assert torch.equal(a, b)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _ref_state(seed):
    jcfg, _, _, _, st = tp.setup(n=N, view_degree=8, seed=seed)
    rng = np.random.default_rng(seed)
    viv = st.viv._replace(
        vec=rng.normal(0, 0.02, st.viv.vec.shape).astype(np.float32),
        height=rng.uniform(1e-5, 0.01, N).astype(np.float32),
        adjustment=rng.uniform(-0.01, 0.01, N).astype(np.float32))
    vec = np.array(viv.vec)
    vec[9, 0] = np.nan
    alive = rng.random(N) < 0.8
    left = (rng.random(N) < 0.1) & alive
    return st._replace(viv=viv._replace(vec=vec), alive_truth=alive, left=left,
                       t=np.int32(21))


def test_project_packed_equals_unpacked_and_reference():
    st = _ref_state(4)
    jpacked = tp.np_tree(jlayout.pack(st))
    service = (np.arange(N) % 3).astype(np.int32)
    ref = tp.np_tree(jserving.project(jlayout.unpack(jpacked), service))
    packed = convert.packed_state_from(jpacked)
    svc = torch.from_numpy(service)
    got = tserving.project(packed, svc)
    dense = tserving.project(tlayout.unpack(packed), svc)
    for f in tserving.Snapshot._fields:
        a, b = getattr(got, f), getattr(dense, f)
        # Bit for bit (row 9 holds a NaN, which equals nothing).
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), f
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert not bool(got.known[9]) and int(got.tick) == 21
    # The snapshot owns its tensors: none aliases a leaf of the state.
    ptrs = {x.data_ptr() for x in tlayout.leaves(packed)}
    assert not ptrs & {x.data_ptr() for x in got[:5] + (got.tick,)}


# -- host coordinates against the reference's server/rtt.py ------------

def make_coord_sets(n=12, seed=7, dims=4):
    """As tests/test_serving.py makes them: continuous coordinates, one
    huge negative adjustment (the clamp), one off-dimension node."""
    rng = random.Random(seed)
    sets = {}
    for i in range(n):
        sets[f"n{i}"] = {"": {
            "vec": [rng.uniform(-0.05, 0.05) for _ in range(dims)],
            "height": rng.uniform(1e-5, 0.01),
            "adjustment": rng.uniform(-0.02, 0.02),
        }}
    sets["n3"][""]["adjustment"] = -10.0
    sets["n7"] = {"": {"vec": [0.1, 0.2], "height": 0.001, "adjustment": 0.0}}
    return sets


def host_pair_distance(sets, a, b):
    sa, sb = sets.get(a), sets.get(b)
    if not sa or not sb:
        return math.inf
    return jrtt.compute_distance(*jrtt.intersect(sa, sb))


def _names(rows):
    return [r["node"] for r in rows]


def test_rtt_copy_matches_reference():
    sets = make_coord_sets()
    sets["n1"]["alpha"] = {"vec": [0.0] * 4, "height": 0.0, "adjustment": 0.0}
    rows = [{"node": f"n{i}"} for i in range(12)] + [{"node": "ghost"}]
    for src in ("n0", "n1", "n3"):
        assert _names(trtt.sort_nodes_by_distance(sets, src, rows)) == \
            _names(jrtt.sort_nodes_by_distance(sets, src, rows))
        for b in ("n2", "n7"):
            assert trtt.compute_distance(*trtt.intersect(sets[src], sets[b])) \
                == host_pair_distance(sets, src, b)
    store = [{"node": "a", "coord": {"vec": [1]}},
             {"node": "a", "segment": "s", "coord": {"vec": [2]}}]
    assert trtt.coord_sets_from_store(store) == jrtt.coord_sets_from_store(store)


@pytest.mark.parametrize("seed,src", [(7, "n0"), (11, "n1"), (11, "n3"),
                                      (11, "n5")])
def test_sort_rows_matches_reference(seed, src):
    sets = make_coord_sets(seed=seed)
    rows = [{"node": f"n{i}"} for i in range(12)]
    rows += [{"node": "ghost"}, {"node": "ghost2"}]
    random.Random(3).shuffle(rows)
    plane = ServingPlane(k=4, buckets=(1, 4, 16), device="cpu")
    got = plane.sort_rows(sets, src, [dict(r) for r in rows])
    want = jrtt.sort_nodes_by_distance(sets, src, [dict(r) for r in rows])
    assert _names(got) == _names(want)
    assert {r["node"] for r in got[-3:]} == {"n7", "ghost", "ghost2"}
    assert plane.batcher.queries == len(rows)


def test_node_distance_unknown_and_clamp():
    sets = make_coord_sets()
    plane = ServingPlane(k=2, buckets=(1, 4), device="cpu")
    assert plane.publish_coords(sets)
    for a, b in [("n0", "n1"), ("n0", "n3"), ("n2", "n5"), ("n3", "n5"),
                 ("n0", "n0")]:
        want = host_pair_distance(sets, a, b)
        assert plane.node_distance(a, b) == pytest.approx(want, rel=1e-4,
                                                          abs=1e-6)
    c3, c5 = sets["n3"][""], sets["n5"][""]
    unadjusted = math.dist(c3["vec"], c5["vec"]) + c3["height"] + c5["height"]
    assert host_pair_distance(sets, "n3", "n5") == pytest.approx(unadjusted)
    assert math.isinf(plane.node_distance("n0", "n7"))
    assert math.isinf(plane.node_distance("n0", "ghost"))
    near = plane.nearest("n0")
    assert near.nodes[0][0] == "n0" and near.count == 12


def test_unknown_source_and_segments_use_the_host_path():
    sets = make_coord_sets()
    rows = [{"node": f"n{i}"} for i in range(12)]
    plane = ServingPlane(k=4, buckets=(1, 16), device="cpu")
    assert _names(plane.sort_rows(sets, "nope", rows)) == _names(rows)
    sets["n1"]["alpha"] = {"vec": [0.0] * 4, "height": 0.0, "adjustment": 0.0}
    got = plane.sort_rows(sets, "n0", [dict(r) for r in rows])
    want = jrtt.sort_nodes_by_distance(sets, "n0", [dict(r) for r in rows])
    assert _names(got) == _names(want)
    assert plane.batcher.queries == 0  # the batched path never ran


# -- a simulation with a plane attached ----------------------------------

def _sim(cls=Simulation, seed=3, n=N):
    return cls(SimConfig(n=n, view_degree=8), seed=seed, kernel="torch",
               device="cpu")


@pytest.fixture(scope="module")
def served_sim():
    sim = _sim()
    sim.run(64, chunk=32, with_metrics=False)
    plane = ServingPlane(k=8, buckets=(1, 4, 16), device="cpu")
    sim.attach_serving(plane)
    return sim, plane


def test_fresh_simulation_nearest_is_the_lowest_ids():
    sim = _sim(seed=8, n=128)
    plane = ServingPlane(k=8, buckets=(4,), device="cpu")
    sim.attach_serving(plane)
    assert plane.tick == 0
    for res in plane.nearest_many([5, 77, 127]):
        assert [node for node, _ in res.nodes] == list(range(8))
    sim.kill(torch.arange(128) < 13)
    assert [node for node, _ in plane.nearest(40).nodes] == list(range(13, 21))


def test_nearest_matches_host_math_on_snapshot_coords(served_sim):
    sim, plane = served_sim
    snap = plane.snapshot()
    vec, height, adj = snap.vec.numpy(), snap.height.numpy(), snap.adjustment.numpy()
    src = 5
    res = plane.nearest(src)
    assert res.count == int(snap.live.sum())
    coord = lambda i: {"vec": vec[i].tolist(), "height": float(height[i]),  # noqa: E731
                       "adjustment": float(adj[i])}
    rtts = [r for _, r in res.nodes]
    assert rtts == sorted(rtts)
    for node, r in res.nodes:
        assert r == pytest.approx(jrtt.compute_distance(coord(src), coord(node)),
                                  rel=1e-5, abs=1e-7)


def test_held_snapshot_keeps_its_tick(served_sim):
    sim, plane = served_sim
    old = plane.snapshot()
    old_tick, old_vec = int(old.tick), old.vec.clone()
    sim.run(32, chunk=32, with_metrics=False)
    assert plane.tick == old_tick + 32
    assert int(old.tick) == old_tick and torch.equal(old.vec, old_vec)
    assert not torch.equal(plane.snapshot().vec, old_vec)


@pytest.mark.parametrize("cls", [Simulation, SerfSimulation])
def test_kill_leaves_nearest_and_health_catalog_keeps_dead(cls):
    sim = _sim(cls)
    sim.run(32, chunk=32, with_metrics=False)
    plane = ServingPlane(k=8, buckets=(1, 4), device="cpu")
    sim.attach_serving(plane)
    before = plane.health_nodes().count
    dead = torch.arange(N) < 8
    sim.kill(dead)
    assert all(node >= 8 for node, _ in plane.nearest(20).nodes)
    assert plane.health_nodes().count == before - 8
    assert plane.catalog_nodes().count == N
    sim.revive(dead)
    assert plane.health_nodes().count == before


@pytest.mark.parametrize("cls,writes", [(Simulation, False),
                                        (Simulation, True),
                                        (SerfSimulation, True)])
def test_attached_plane_leaves_the_trajectory(cls, writes):
    plain = _sim(cls, seed=6)
    plain.run(64, chunk=16, with_metrics=False)
    served = _sim(cls, seed=6)
    plane = ServingPlane(k=8, num_services=4, device="cpu")
    served.attach_serving(plane, writes=writes, kv_slots=8)
    for _ in range(4):
        if writes:
            plane.writes.execute([(1, 3, 2), (3, 0, 9)])
        plane.nearest_many([1, 2, 3])
        served.run(16, chunk=16, with_metrics=False)
    for a, b in zip(tlayout.leaves(plain.state), tlayout.leaves(served.state)):
        assert torch.equal(a, b)
    assert plain.gen.get_state().equal(served.gen.get_state())
    assert plane.tick == 64


# -- QueryBatcher ----------------------------------------------------------

def test_bucketing_pads_to_fixed_shapes(served_sim):
    _, plane = served_sim
    b = QueryBatcher(plane, k=4, buckets=(1, 4, 16))
    b.execute([(MODE_NEAREST, 2, -1)] * 3)
    assert b.batches == 1 and b.queries == 3 and b.padded_slots == 1
    assert b.stats()["padding_waste_pct"] == pytest.approx(25.0)


def test_oversize_batch_chunks_at_max_bucket(served_sim):
    _, plane = served_sim
    b = QueryBatcher(plane, k=4, buckets=(1, 4))
    out = b.execute([(MODE_DIST, i % N, (i + 1) % N) for i in range(10)])
    assert len(out) == 10 and b.batches == 3
    assert all(r.count == 1 for r in out)


def test_concurrent_submits_coalesce_and_fan_out(served_sim):
    _, plane = served_sim
    b = QueryBatcher(plane, k=4, buckets=(1, 4, 16), max_wait_s=0.05)
    results, errors = {}, []

    def reader(i):
        try:
            results[i] = b.submit(MODE_DIST, i, (i + 1) % N, timeout_s=10.0)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=reader, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
        assert not t.is_alive()
    assert not errors and len(results) == 12 and b.queries == 12
    snap = plane.snapshot()
    for i, r in results.items():
        want = tserving.execute(1, snap, torch.tensor([MODE_DIST]),
                                torch.tensor([i]), torch.tensor([(i + 1) % N]))
        assert r.count == 1 and r.rtts[0] == float(want[1][0, 0])
    assert b.batches < 12


def test_closed_batcher_rejects_and_wakes(served_sim):
    _, plane = served_sim
    b = QueryBatcher(plane, k=4, buckets=(4,), max_wait_s=5.0)
    err = {}

    def parked():
        try:
            b.submit(MODE_NEAREST, 1, timeout_s=30.0)
        except ServingClosedError as e:
            err["e"] = e

    t = threading.Thread(target=parked)
    t.start()
    while not b._pending and t.is_alive():
        t.join(timeout=0.001)
    b.close()
    t.join(timeout=5.0)
    assert not t.is_alive() and "e" in err
    with pytest.raises(ServingClosedError):
        b.submit(MODE_NEAREST, 1)
    b.close()


def test_telemetry_and_cache_front(served_sim):
    sim, plane = served_sim
    q0 = sim.sink.counter_sum("sim.serving.queries")
    p0 = sim.sink.counter_sum("sim.serving.padded_slots")
    plane.batcher.execute([(MODE_NEAREST, 1, -1)] * 3)
    assert sim.sink.counter_sum("sim.serving.queries") == q0 + 3
    assert sim.sink.counter_sum("sim.serving.padded_slots") == p0 + 1
    cache = Cache()
    plane.register_cache_type(cache, ttl_s=30.0)
    hits = plane.cache_hits
    v1 = plane.cached_nearest(cache, 3)
    v2 = plane.cached_nearest(cache, 3)
    assert v1 == v2 and v1["nodes"][0][0] == 3
    assert cache.fetch_count("serving-nearest", src=3, service=-1) == 1
    assert plane.cache_hits == hits + 1
    cache.close()


def test_plane_guards(served_sim):
    _, plane = served_sim
    with pytest.raises(RuntimeError, match="simulation"):
        plane.publish_coords(make_coord_sets())
    host = ServingPlane(k=2, buckets=(1, 4), device="cpu")
    assert host.publish_coords(make_coord_sets())
    with pytest.raises(RuntimeError, match="host"):
        host.attach(object())
    with pytest.raises(RuntimeError, match="snapshot"):
        ServingPlane(k=2, buckets=(1,), device="cpu").nearest(0)
