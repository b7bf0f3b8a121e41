"""PyTorch port vs the JAX reference: the serving plane's write path and
watch plane (``consul_tpu_torch/ops/deltas.py``,
``serving/{writes,watch,mixed}.py``).

- ``apply_writes`` equals the reference's ``deltas.apply_writes`` and the
  numpy oracle ``apply_writes_reference`` exactly on random batches over
  every op family, NOOP padding, out-of-range targets and negative
  arguments, and on a batch with duplicate targets (last writer wins,
  1-based rank indexes).
- ``diff_snapshots`` equals the reference's ``diff_kernel_for(k)`` and
  ``diff_snapshots_reference`` exactly, a truncated frame (count > k)
  and k > n included.
- ``WriteBatcher`` and ``WatchPlane`` on a simulation (n = 32, CPU), on
  flows of ``tests/test_writes.py``: a write is invisible until the
  flip, the apply index is monotone and threads the counters, admission
  policies, watch routing and truncation, blocking index waits, close.
- ``run_mixed`` at a small size: its write state equals the oracle's
  replay of the batches it applied, and each flip's frame equals
  ``diff_snapshots_reference`` on that flip's pairs.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from consul_tpu.ops import deltas as jdeltas
from consul_tpu.ops.serving import Snapshot as JSnapshot
from consul_tpu_torch import convert
from consul_tpu_torch.config import SimConfig
from consul_tpu_torch.models.cluster import Simulation
from consul_tpu_torch.ops import deltas
from consul_tpu_torch.serving import (ServingClosedError, ServingOverloadError,
                                      ServingPlane)
from consul_tpu_torch.serving.mixed import parse_ratio, run_mixed
from consul_tpu_torch.serving.watch import Watcher, WatchEvent
from consul_tpu_torch.serving.writes import WriteBatcher

N = 32


def _sim(n=N, seed=3):
    sim = Simulation(SimConfig(n=n, view_degree=4), seed=seed, kernel="torch",
                     device="cpu")
    sim.run(16, chunk=8, with_metrics=False)
    return sim


@pytest.fixture(scope="module")
def wsim():
    """One formed sim with a write-attached plane, shared by the flows
    (they assert relative change, never absolute apply-index values)."""
    sim = _sim()
    plane = ServingPlane(k=8, num_services=4, device="cpu")
    sim.attach_serving(plane, writes=True, kv_slots=16)
    yield sim, plane
    plane.close()


def _fresh(n=16, kv_slots=8, **attach_kw):
    sim = _sim(n=n, seed=5)
    plane = ServingPlane(k=8, num_services=4, device="cpu")
    sim.attach_serving(plane, writes=True, kv_slots=kv_slots, **attach_kw)
    return sim, plane


def _rand_batch(rng, b, n, s):
    """A random batch covering every op family plus NOOP padding,
    out-of-range targets and negative args (as tests/test_writes.py)."""
    return jdeltas.WriteBatch(
        op=rng.integers(0, 7, size=b).astype(np.int32),
        target=rng.integers(-2, max(n, s) + 3, size=b).astype(np.int32),
        arg=rng.integers(-3, 100, size=b).astype(np.int32))


def _assert_equal(a, b, fields):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)


def _host(tree):
    return type(tree)(*[np.asarray(x) for x in tree])


def test_apply_writes_matches_reference_and_oracle():
    rng = np.random.default_rng(0)
    n, s = 24, 8
    ws_ref = jdeltas.init_state(n, s, service=np.arange(n) % 4)
    ws_j = jax.device_put(ws_ref)
    ws_t = convert.write_state_from(ws_ref)
    for b in (4, 16, 16, 64, 16):
        batch = _rand_batch(rng, b, n, s)
        ws_ref, applied_ref, idx_ref = deltas.apply_writes_reference(ws_ref,
                                                                     batch)
        ws_j, applied_j, idx_j = jax.device_get(
            jdeltas.apply_writes(ws_j, jax.device_put(batch)))
        ws_t, applied_t, idx_t = deltas.apply_writes(
            ws_t, convert.write_batch_from(batch))
        for other in (ws_j, _host(ws_t)):
            _assert_equal(other, ws_ref, deltas.WriteState._fields)
        for applied, idx in ((applied_j, idx_j), (applied_t, idx_t)):
            np.testing.assert_array_equal(np.asarray(applied), applied_ref)
            np.testing.assert_array_equal(np.asarray(idx), idx_ref)
        assert ws_t.service.dtype == torch.int32
        assert ws_t.apply_index.dtype == torch.int32
    assert int(ws_t.apply_index) > 0


def test_last_writer_wins_and_rank_indexes():
    ws = deltas.place(deltas.init_state(4, 2), "cpu")
    batch = deltas.WriteBatch(*[torch.tensor(x, dtype=torch.int32) for x in (
        [deltas.OP_REGISTER, deltas.OP_KV_PUT, deltas.OP_DEREGISTER,
         deltas.OP_NOOP, deltas.OP_KV_PUT, deltas.OP_SESSION_CREATE,
         deltas.OP_SESSION_CREATE, deltas.OP_SESSION_DESTROY,
         deltas.OP_SESSION_CREATE],
        [1, 0, 1, 0, 0, 2, 2, 3, 3],
        [7, 11, -1, -1, 13, 5, 6, -1, 8])])
    new, applied, idx = deltas.apply_writes(ws, batch)
    # Node 1: register then deregister in one batch -> deregistered.
    assert not bool(new.registered[1]) and int(new.service[1]) == -1
    # Slot 0: two puts, the last wins, version = the last op's index.
    assert int(new.kv_val[0]) == 13 and int(new.kv_ver[0]) == 4
    # Sessions: the later create wins on node 2; create after destroy on 3.
    assert new.session.tolist() == [-1, -1, 6, 8]
    assert applied.tolist() == [True, True, True, False, True, True, True,
                                True, True]
    assert idx.tolist() == [1, 2, 3, 3, 4, 5, 6, 7, 8]
    assert int(new.apply_index) == 8
    ref, _, _ = deltas.apply_writes_reference(_host(ws), _host(batch))
    _assert_equal(_host(new), ref, deltas.WriteState._fields)
    # The input state is not written.
    assert int(ws.apply_index) == 0 and bool(ws.registered[1])


def _snap(live, tick):
    """A minimal reference snapshot for the diff (which reads live, tick)."""
    n = len(live)
    return JSnapshot(
        vec=np.zeros((n, 2), np.float32), height=np.zeros(n, np.float32),
        adjustment=np.zeros(n, np.float32), known=np.ones(n, bool),
        live=np.asarray(live, bool), service=np.zeros(n, np.int32),
        tick=np.int32(tick))


@pytest.mark.parametrize("k", [4, 16, 64])
def test_diff_matches_reference_and_oracle(k):
    rng = np.random.default_rng(2)
    n, s = 24, 8
    ws0 = jdeltas.init_state(n, s, service=np.arange(n) % 4)
    ws1 = ws0
    for _ in range(2):
        ws1, _, _ = jdeltas.apply_writes_reference(ws1,
                                                   _rand_batch(rng, 16, n, s))
    live0 = rng.random(n) < 0.8
    live1 = live0 ^ (rng.random(n) < 0.3)
    s0, s1 = _snap(live0, 7), _snap(live1, 9)
    oracle = deltas.diff_snapshots_reference(k, s0, ws0, s1, ws1)
    ref = jax.device_get(jdeltas.diff_kernel_for(k)(
        jax.device_put(s0), jax.device_put(ws0), jax.device_put(s1),
        jax.device_put(ws1)))
    frame = deltas.diff_kernel_for(k)(
        convert.snapshot_from(s0), convert.write_state_from(ws0),
        convert.snapshot_from(s1), convert.write_state_from(ws1))
    got = deltas.frame_to_host(frame)
    for other in (ref, got):
        _assert_equal(other, oracle, deltas.DeltaFrame._fields)
    assert all(x.dtype == np.int32 for x in got)
    if k == 4:
        assert int(oracle.n_node_changes) > 4  # truncated: the count survives


# -- the write path and the watch plane on a simulation -----------------

def test_write_invisible_until_flip(wsim):
    sim, plane = wsim
    before = {node for node, _ in plane.catalog_nodes(2).nodes}
    node = next(i for i in range(N) if i not in before)
    assert plane.register(node, 2).status == "applied"
    assert node not in {n_ for n_, _ in plane.catalog_nodes(2).nodes}
    sim.publish_serving()
    assert node in {n_ for n_, _ in plane.catalog_nodes(2).nodes}


def test_apply_index_monotone_and_threads_the_counters(wsim):
    sim, plane = wsim
    seen = [plane.apply_index]
    for i in range(3):
        res = plane.register(i, 1)
        assert res.index > seen[-1]
        sim.publish_serving()
        seen.append(plane.apply_index)
        assert seen[-1] >= res.index
    assert seen == sorted(seen)
    dev_index = int(plane.write_state.apply_index)
    assert sim.counters_snapshot()["writes_applied"] == dev_index
    assert plane.apply_index == dev_index
    assert sim.sink.counter_sum("sim.serving.writes_applied") == dev_index


def test_kv_reads_are_flip_consistent(wsim):
    sim, plane = wsim
    res = plane.kv_put("cfg/a", 41)
    assert res.status == "applied" and plane.kv_get("cfg/a") is None
    sim.publish_serving()
    assert plane.kv_get("cfg/a") == {"Key": "cfg/a", "Value": 41,
                                     "ModifyIndex": res.index}
    plane.kv_delete("cfg/a")
    sim.publish_serving()
    assert plane.kv_get("cfg/a") is None
    entry = plane.node_entry(5)
    assert entry["Node"] == 5 and entry["Registered"]


def test_execute_pads_and_rejects_invalid(wsim):
    _, plane = wsim
    wb = plane.writes
    pad0, batches0, rejected0 = wb.padded_slots, wb.write_batches, wb.rejected
    out = wb.execute([(deltas.OP_SESSION_CREATE, i, 100 + i) for i in range(5)])
    assert [r.status for r in out] == ["applied"] * 5
    assert wb.write_batches == batches0 + 1 and wb.padded_slots == pad0 + 3
    out = wb.execute([(deltas.OP_REGISTER, N + 7, 1),
                      (deltas.OP_REGISTER, 0, -1),
                      (deltas.OP_KV_PUT, 10_000, 5)])
    assert [r.status for r in out] == ["rejected"] * 3
    assert wb.rejected == rejected0 + 3


def test_concurrent_submits_coalesce(wsim):
    _, plane = wsim
    wb = plane.writes
    batches0 = wb.write_batches
    results = [None] * 8
    # Every pump waits until all 8 submits are queued, so the coalescing
    # does not depend on how the threads are scheduled.
    queued = threading.Event()
    pump = wb.pump

    def held_pump():
        assert queued.wait(timeout=30.0)
        return pump()

    def go(i):
        results[i] = wb.submit(deltas.OP_SESSION_CREATE, i, 500 + i)

    wb.pump = held_pump
    try:
        threads = [threading.Thread(target=go, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30.0
        while True:
            with wb._lock:
                if len(wb._pending) == 8:
                    break
            assert time.monotonic() < deadline
            time.sleep(0.001)
        queued.set()
        for t in threads:
            t.join(timeout=30.0)
            assert not t.is_alive()
    finally:
        queued.set()
        del wb.pump
    assert all(r.status == "applied" for r in results)
    assert wb.write_batches - batches0 < 8
    assert len({r.index for r in results}) == 8


def test_admission_policies(wsim):
    _, plane = wsim
    wb = WriteBatcher(plane, buckets=(4,), max_pending=0, policy="reject")
    with pytest.raises(ServingOverloadError):
        wb.submit(deltas.OP_REGISTER, 1, 2)
    assert wb.rejected == 1
    wb = WriteBatcher(plane, buckets=(4,), max_wait_s=0.5, max_pending=1,
                      policy="shed_oldest")
    results = {}
    t = threading.Thread(target=lambda: results.update(
        first=wb.submit(deltas.OP_REGISTER, 1, 2)))
    t.start()
    deadline = time.monotonic() + 2.0
    while not wb._pending and time.monotonic() < deadline:
        time.sleep(0.001)
    out = wb.submit(deltas.OP_REGISTER, 2, 3)
    t.join(timeout=5.0)
    assert results["first"].status == "shed" and not results["first"].applied
    assert out.status == "applied" and wb.shed == 1


def test_kv_slot_exhaustion_is_overload():
    _, plane = _fresh(kv_slots=2)
    try:
        plane.kv_put("a", 1)
        plane.kv_put("b", 2)
        with pytest.raises(ServingOverloadError):
            plane.kv_put("c", 3)
        plane.kv_delete("a")
        assert plane.kv_put("a", 9).status == "applied"
    finally:
        plane.close()


def test_service_watch_routes_old_and_new_label(wsim):
    sim, plane = wsim
    plane.register(9, 1)
    sim.publish_serving()
    w_old = plane.watch.register("service", 1)
    w_new = plane.watch.register("service", 2)
    try:
        res = plane.register(9, 2)
        sim.publish_serving()
        for ev in (w_old.poll(timeout_s=5.0), w_new.poll(timeout_s=5.0)):
            assert ev is not None and ev.index >= res.index
            assert any(nid == 9 and kinds & deltas.CHANGE_SERVICE
                       for nid, kinds in ev.changes)
    finally:
        plane.watch.unregister(w_old)
        plane.watch.unregister(w_new)


def test_kv_prefix_and_health_watches(wsim):
    sim, plane = wsim
    w = plane.watch.register("kv_prefix", "app/")
    wn = plane.watch.register("node", 30)
    try:
        res = plane.kv_put("app/port", 8500)
        plane.kv_put("other/key", 1)
        sim.kill(torch.arange(N) == 30)
        ev = w.poll(timeout_s=5.0)
        assert ev is not None and ev.key == "app/"
        assert {key for key, _ in ev.changes} == {"app/port"}
        assert ("app/port", res.index) in ev.changes
        ev = wn.poll(timeout_s=5.0)
        assert ev is not None and ev.changes == ((30, deltas.CHANGE_WENT_DEAD),)
    finally:
        sim.revive(torch.arange(N) == 30)
        plane.watch.unregister(w)
        plane.watch.unregister(wn)


def test_bounded_queue_sheds_oldest():
    w = Watcher("any", None, max_queue=2)
    mk = lambda i: WatchEvent(kind="any", key=None, index=i, tick=i,  # noqa: E731
                              changes=(), truncated=False)
    assert w._offer(mk(1)) and w._offer(mk(2))
    assert not w._offer(mk(3))
    assert w.dropped == 1 and [ev.index for ev in w.queue] == [2, 3]


def test_truncated_frame_flags_watchers():
    sim, plane = _fresh(n=16, watch_k=4)
    try:
        w = plane.watch.register("any")
        plane.writes.execute([(deltas.OP_DEREGISTER, i, -1) for i in range(6)])
        sim.publish_serving()
        ev = w.poll(timeout_s=5.0)
        assert ev is not None and ev.truncated
        assert plane.watch.truncated_frames >= 1
    finally:
        plane.close()


def test_wait_index(wsim):
    sim, plane = wsim
    plane.register(0, 1)
    sim.publish_serving()
    cur = plane.apply_index
    t0 = time.monotonic()
    assert plane.watch.wait_index(cur - 1, wait_s=5.0) >= cur
    assert time.monotonic() - t0 < 1.0

    def later():
        time.sleep(0.05)
        plane.writes.execute([(deltas.OP_SESSION_CREATE, 2, 7)])
        sim.publish_serving()

    t = threading.Thread(target=later)
    t.start()
    t0 = time.monotonic()
    assert plane.watch.wait_index(cur, wait_s=10.0) > cur
    t.join(timeout=10.0)
    assert time.monotonic() - t0 >= 0.03
    target = plane.apply_index + 10_000
    assert plane.watch.wait_index(target, wait_s=0.05) >= target


def test_close_rejects_and_wakes_everything():
    _, plane = _fresh()
    w = plane.watch.register("any")
    wb = WriteBatcher(plane, buckets=(4,), max_wait_s=5.0)
    got = {}

    def parked():
        try:
            wb.submit(deltas.OP_REGISTER, 1, 2, timeout_s=30.0)
        except ServingClosedError as e:
            got["err"] = e

    threads = [threading.Thread(target=parked),
               threading.Thread(target=lambda: got.update(ev=w.poll(30.0))),
               threading.Thread(target=lambda: got.update(
                   idx=plane.watch.wait_index(plane.apply_index + 100, 30.0)))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 2.0
    while not wb._pending and time.monotonic() < deadline:
        time.sleep(0.001)
    time.sleep(0.05)
    wb.close()
    plane.close()
    for t in threads:
        t.join(timeout=5.0)
        assert not t.is_alive()
    assert isinstance(got.get("err"), ServingClosedError)
    assert got["ev"] is None
    assert plane.closed and plane.batcher.closed and plane.writes.closed
    with pytest.raises(ServingClosedError):
        plane.batcher.submit(0, 0, -1)
    with pytest.raises(ServingClosedError):
        plane.writes.submit(deltas.OP_REGISTER, 0, 1)
    with pytest.raises(ServingClosedError):
        plane.watch.register("any")
    plane.close()


def test_run_mixed_matches_the_oracles():
    assert parse_ratio("90:9:1") == (90, 9, 1)
    with pytest.raises(ValueError):
        parse_ratio("0:1:1")
    sim = _sim(n=64, seed=7)
    plane = ServingPlane(k=8, buckets=(16,), num_services=8, device="cpu")
    sim.attach_serving(plane, writes=True, kv_slots=256, watch_k=8)
    ws0 = _host(plane.write_state)
    batches, flips = [], []
    real_execute, real_on_flip = plane.writes.execute, plane.watch.on_flip

    def execute(ops):
        batches.append(list(ops))
        return real_execute(ops)

    def on_flip(prev, cur):
        real_on_flip(prev, cur)
        flips.append((prev, cur, plane.watch.last_frame))

    plane.writes.execute, plane.watch.on_flip = execute, on_flip
    out = run_mixed(sim, plane, ratio="90:9:1", rounds=3, read_batch=16,
                    watchers=8, seed=0)
    assert out["read"]["count"] == 48 and out["write"]["count"] == 6
    assert out["watch"]["flips"] == 3 and out["watch"]["watchers"] == 9
    assert out["apply_index"] == int(plane.write_state.apply_index) > 0
    ws = ws0
    for ops in batches:
        batch = deltas.WriteBatch(*np.asarray(ops, np.int32).T)
        ws, _, _ = deltas.apply_writes_reference(ws, batch)
    _assert_equal(_host(plane.write_state), ws, deltas.WriteState._fields)
    assert len(flips) == 4
    for (ps, pw), (cs, cw), frame in flips:
        want = deltas.diff_snapshots_reference(
            8, _host(ps), _host(pw), _host(cs), _host(cw))
        _assert_equal(frame, want, deltas.DeltaFrame._fields)
    plane.close()
