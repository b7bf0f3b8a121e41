"""PyTorch port vs the JAX reference: meshes of devices and the row-axis
collectives, sharded.

- ``parallel/mesh.py``: ``default_mesh``, ``elastic_mesh``, ``node_axes``
  and ``mesh_key`` over repeated ``"cpu"`` devices against the
  reference's own functions over its 8 virtual CPU devices
  (tests/conftest.py); the row-block split and its gather.
- ``parallel/collective.py`` at 2, 4 and 8 shards (threads on the CPU,
  ``shard_step.run_shards``) against one device: ``roll`` with host and
  tensor shifts on 1-D, 2-D and bool tensors, ``roll_many``, ``rows`` /
  ``local_n``, ``any_rows``, ``all_rows``, ``take_rows``,
  ``sum_scatter_rows``, ``tree_psum`` and ``shard_once`` (cf.
  tests/test_shardmap.py:67-173); every result equal.
- Device groups (``mesh.device_groups``: runs of shards on one device)
  and the adjacent placement: ``split`` / ``adjoin`` hand each group's
  shards row views of one storage per leaf (full height for the leaves
  named), checked by ``data_ptr``; ``group_view`` reads a group whole
  without a copy and refuses blocks that are not adjacent; ``join``
  returns a copy. The sharded CUDA tick's exchange plan and its bytes
  under one group per device and one group per shard: only other
  groups' rows move, none with one group.
- A shard that fails ends the run with its own exception, and a shard
  that never reaches the barrier fails the run at the barrier's timeout
  instead of hanging it.
"""

import time

import jax
import numpy as np
import pytest
import torch

from consul_tpu.parallel import mesh as jmesh
from consul_tpu_torch.config import SimConfig
from consul_tpu_torch.models import layout as tlayout
from consul_tpu_torch.models import state as tstate
from consul_tpu_torch.ops import cuda_gossip as cg
from consul_tpu_torch.parallel import collective as coll
from consul_tpu_torch.parallel import mesh as tmesh
from consul_tpu_torch.parallel import shard_step

torch.set_num_threads(1)

N = 64
SHARDS = (2, 4, 8)
SHIFTS = [0, 1, 7, 8, 9, 32, 63, -3, -17, 100]


def _cpu(k):
    return ["cpu"] * k


def _shape(mesh):
    return tuple(mesh.shape)


# -- mesh builders against the reference ---------------------------------

@pytest.mark.parametrize("kw", [
    dict(n=256), dict(n=256, device_count=1), dict(n=256, n_dc=2),
    dict(n=12), dict(n=256, n_dc=3), dict(n=256, device_count=4)],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_default_mesh_matches_the_reference(kw):
    ref = jmesh.default_mesh(**kw)
    got = tmesh.default_mesh(**kw, devices=_cpu(len(jax.devices())))
    if ref is None:
        assert got is None
        return
    assert got.axis_names == tuple(ref.axis_names)
    assert _shape(got) == tuple(ref.shape[a] for a in ref.axis_names)
    assert tmesh.node_axes(got)[1] == jmesh.node_axes(ref)[1]


@pytest.mark.parametrize("n,k,n_dc", [
    (256, 8, 1), (12, 8, 1), (7, 8, 1), (256, 6, 2), (30, 8, 3), (256, 5, 4),
    (256, 2, 3)])
def test_elastic_mesh_trims_as_the_reference(n, k, n_dc):
    try:
        ref = jmesh.elastic_mesh(n, jax.devices()[:k], n_dc=n_dc)
    except ValueError:
        with pytest.raises(ValueError, match="no usable mesh"):
            tmesh.elastic_mesh(n, _cpu(k), n_dc=n_dc)
        return
    got = tmesh.elastic_mesh(n, _cpu(k), n_dc=n_dc)
    assert got.axis_names == tuple(ref.axis_names)
    assert _shape(got) == tuple(ref.shape[a] for a in ref.axis_names)


def test_node_axes_and_mesh_key():
    flat, grid = tmesh.make_mesh(_cpu(8)), tmesh.make_mesh(_cpu(8), n_dc=2)
    assert tmesh.node_axes(flat) == (tmesh.NODE_AXIS, 8)
    assert tmesh.node_axes(grid) == ((tmesh.DC_AXIS, tmesh.NODE_AXIS), 8)
    assert jmesh.node_axes(jmesh.make_mesh(jax.devices()[:8], n_dc=2))[1] == 8
    keys = {tmesh.mesh_key(m) for m in (flat, grid, tmesh.make_mesh(_cpu(4)))}
    assert len(keys) == 3 and tmesh.mesh_key(None) is None
    assert tmesh.mesh_key(tmesh.make_mesh(_cpu(8))) == tmesh.mesh_key(flat)
    with pytest.raises(ValueError, match="divide evenly"):
        tmesh.make_mesh(_cpu(6), n_dc=4)


def test_split_and_join_round_trip():
    x = torch.arange(N * 3).reshape(N, 3)
    tree = (x, torch.tensor(5), torch.arange(3))
    blocks = tmesh.split(tmesh.make_mesh(_cpu(4)), tree, N)
    assert [b[0].shape[0] for b in blocks] == [N // 4] * 4
    assert all(b[1] is not tree[1] and int(b[1]) == 5 for b in blocks)
    back = tmesh.join(blocks, N, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, tree))
    with pytest.raises(ValueError, match="must divide"):
        tmesh.split(tmesh.make_mesh(_cpu(3)), tree, N)


# -- collectives at 2, 4 and 8 shards against one device ----------------

def _spmd(r, fn, *full):
    """``fn`` per shard on its rows of each ``full`` tensor (leading dim
    N); the shards' results concatenated in shard order."""
    mesh = tmesh.make_mesh(_cpu(r))
    blocks = [tmesh.block_of(full, N, d, r, "cpu") for d in range(r)]
    out = shard_step.run_shards(mesh, N, lambda d, xs: fn(*xs),
                                [(b,) for b in blocks])
    return out


def _cat(out):
    return torch.cat(out)


def _inputs():
    g = torch.Generator().manual_seed(0)
    return dict(
        ints=torch.randint(-2 ** 31, 2 ** 31 - 1, (N,), generator=g,
                           dtype=torch.int64),
        rows2d=torch.randint(0, 1000, (N, 5), generator=g),
        bools=torch.rand((N,), generator=g) < 0.3)


@pytest.mark.parametrize("r", SHARDS)
@pytest.mark.parametrize("kind", ["ints", "rows2d", "bools"])
def test_roll_static_shifts(r, kind):
    x = _inputs()[kind]
    for shift in SHIFTS:
        got = _cat(_spmd(r, lambda xl, s=shift: coll.roll(xl, s), x))
        assert torch.equal(got, coll.roll(x, shift)), (r, kind, shift)
        assert torch.equal(got, torch.roll(x, shift, 0))


@pytest.mark.parametrize("r", SHARDS)
def test_roll_tensor_shift_and_roll_many(r):
    ins = _inputs()
    for shift in (0, 5, 40, -9):
        s = torch.tensor(shift)
        got = _spmd(r, lambda a, b, c: coll.roll_many([a, b, c], s),
                    ins["ints"], ins["rows2d"], ins["bools"])
        for i, x in enumerate((ins["ints"], ins["rows2d"], ins["bools"])):
            assert torch.equal(torch.cat([o[i] for o in got]),
                               torch.roll(x, shift, 0)), (r, shift, i)


@pytest.mark.parametrize("r", SHARDS)
def test_rows_and_row_reads(r):
    ins = _inputs()
    idx = torch.randint(0, N, (N, 3), generator=torch.Generator().manual_seed(1))
    got = _spmd(r, lambda x, i: (coll.rows(N), coll.local_n(N),
                                 coll.all_rows(x), coll.take_rows(x, i)),
                ins["rows2d"], idx)
    assert torch.equal(torch.cat([o[0] for o in got]), coll.rows(N))
    assert {o[1] for o in got} == {N // r}
    assert all(torch.equal(o[2], ins["rows2d"]) for o in got)
    assert torch.equal(torch.cat([o[3] for o in got]),
                       coll.take_rows(ins["rows2d"], idx))


@pytest.mark.parametrize("r", SHARDS)
def test_any_rows_and_tree_psum(r):
    for hit in (None, 0, N - 1, N // 2 + 1):
        m = torch.zeros(N, dtype=torch.bool)
        if hit is not None:
            m[hit] = True
        got = _spmd(r, lambda x: coll.any_rows(x), m)
        assert all(bool(g) == bool(coll.any_rows(m)) for g in got), (r, hit)
    vals = torch.arange(N * 2, dtype=torch.int32).reshape(N, 2)
    got = _spmd(r, lambda x: coll.tree_psum(x.sum(dim=0)), vals)
    assert all(torch.equal(g, vals.sum(dim=0)) for g in got)
    once = _spmd(r, lambda x: coll.shard_once(x.sum()), vals)
    assert int(sum(once)) == int(once[0]) and int(once[0]) != 0


@pytest.mark.parametrize("r", SHARDS)
def test_sum_scatter_rows(r):
    g = torch.Generator().manual_seed(2)
    idx = torch.randint(0, N, (N,), generator=g)
    vals = torch.randint(0, 5, (N, 4), generator=g)
    got = _spmd(r, lambda i, v: coll.sum_scatter_rows(i, v, N), idx, vals)
    assert torch.equal(_cat(got), coll.sum_scatter_rows(idx, vals, N))


def test_outside_a_context_nothing_moves():
    x = _inputs()["rows2d"]
    assert not coll.sharded() and coll.local_n(N) == N
    assert coll.all_rows(x) is x and coll.tree_psum(x) is x
    with coll.node_axis(4, N, 1):
        assert torch.equal(coll.rows(N), torch.arange(N // 4, N // 2))
        with pytest.raises(RuntimeError, match="shard board"):
            coll.all_rows(x[:N // 4])
    with pytest.raises(ValueError, match="not divisible"):
        with coll.node_axis(3, N, 0):
            pass


# -- what must fail rather than hang --------------------------------------

def test_a_failing_shard_breaks_the_barrier_for_all():
    mesh = tmesh.make_mesh(_cpu(4))

    def fn(d, x):
        if d == 2:
            raise ZeroDivisionError("shard 2")
        return coll.all_rows(x)

    blocks = [(torch.zeros(N // 4),)] * 4
    with pytest.raises(ZeroDivisionError, match="shard 2"):
        shard_step.run_shards(mesh, N, fn, blocks)


def test_a_missing_shard_fails_at_the_barrier_timeout(monkeypatch):
    monkeypatch.setattr(coll, "BARRIER_TIMEOUT_S", 0.5)
    mesh = tmesh.make_mesh(_cpu(2))

    def fn(d, x):
        if d == 1:
            return x  # never posts: shard 0 waits alone
        return coll.all_rows(x)

    t0 = time.perf_counter()
    with pytest.raises(coll.ShardAborted):
        shard_step.run_shards(mesh, N, fn, [(torch.zeros(N // 2),)] * 2)
    assert time.perf_counter() - t0 < 30.0


def test_reference_mesh_builders_are_numpy_free_here():
    # The port's mesh holds torch devices only (no jax objects).
    m = tmesh.make_mesh(_cpu(2))
    assert all(isinstance(d, torch.device) for d in m.devices)
    assert np.asarray(m.shape).tolist() == [2]


# -- device groups and the adjacent placement ------------------------------

@pytest.mark.parametrize("devs,want", [
    (["cpu"] * 4, ((0, 1, 2, 3),)),
    (["cpu", "cpu", "meta", "meta"], ((0, 1), (2, 3))),
    (["cpu", "meta", "cpu"], ((0,), (1,), (2,))),
    (["cpu"], ((0,),))], ids=["one", "two", "runs", "single"])
def test_device_groups(devs, want):
    mesh = tmesh.make_mesh(devs)
    assert tmesh.device_groups(mesh) == want
    assert tmesh.check_groups(mesh) == want
    assert tmesh.shard_groups(mesh) == tuple((d,) for d in range(len(devs)))
    assert tmesh.check_groups(mesh, [list(g) for g in want]) == want


@pytest.mark.parametrize("bad", [((0, 2), (1, 3)), ((0, 1),), ((1, 0), (2, 3)),
                                 ((0, 1, 2), (3,)), ((0, 1), (), (2, 3))])
def test_check_groups_refuses_what_is_not_a_grouping(bad):
    with pytest.raises(ValueError, match="groups|group"):
        tmesh.check_groups(tmesh.make_mesh(["cpu", "cpu", "meta", "meta"]), bad)


def _tree():
    return (torch.arange(N * 3, dtype=torch.int64).reshape(N, 3),
            torch.arange(N, dtype=torch.int16), torch.tensor(5))


@pytest.mark.parametrize("r", SHARDS)
@pytest.mark.parametrize("grouping", ["device", "shard"])
def test_split_places_each_group_as_adjacent_views(r, grouping):
    mesh = tmesh.make_mesh(_cpu(r))
    groups = (tmesh.device_groups(mesh) if grouping == "device"
              else tmesh.shard_groups(mesh))
    tree, b = _tree(), N // r
    blocks = tmesh.split(mesh, tree, N, groups=groups, full={"1"})
    for g in groups:
        lo, hi = g[0] * b, (g[-1] + 1) * b
        xs = [blocks[d][0] for d in g]
        assert [x.data_ptr() for x in xs] == [
            xs[0].data_ptr() + i * b * 3 * 8 for i in range(len(g))]
        assert xs[0].untyped_storage().nbytes() == len(g) * b * 3 * 8
        whole = tmesh.group_view(xs, g, b, N)
        assert whole.data_ptr() == xs[0].data_ptr()
        assert torch.equal(whole, tree[0][lo:hi])
        # A full-height leaf: the group's rows in their place among N.
        ys = [blocks[d][1] for d in g]
        full = tmesh.group_view(ys, g, b, N, full=True)
        assert full.shape[0] == N and ys[0].untyped_storage().nbytes() == N * 2
        assert full.data_ptr() == ys[0].data_ptr() - lo * 2
        assert torch.equal(full[lo:hi], tree[1][lo:hi])
        assert all(int(blocks[d][2]) == 5 for d in g)
    assert len({blocks[g[0]][0].untyped_storage().data_ptr()
                for g in groups}) == len(groups)
    back = tmesh.join(blocks, N, "cpu")
    assert all(torch.equal(a, c) for a, c in zip(back, tree))


def test_join_returns_a_copy():
    tree = _tree()
    blocks = tmesh.split(tmesh.make_mesh(_cpu(4)), tree, N)
    back = tmesh.join(blocks, N, "cpu")
    assert back[0].data_ptr() != blocks[0][0].data_ptr()
    back[0].add_(1)
    back[1].add_(1)
    again = tmesh.join(blocks, N, "cpu")
    assert torch.equal(again[0], tree[0]) and torch.equal(again[1], tree[1])


def test_adjoin_places_loose_blocks_and_group_view_refuses_them():
    mesh, b = tmesh.make_mesh(_cpu(4)), N // 4
    x = torch.arange(N * 2).reshape(N, 2)
    loose = [tmesh.block_of((x,), N, d, 4, "cpu") for d in range(4)]
    with pytest.raises(ValueError, match="parallel.mesh.split"):
        tmesh.group_tree(loose, (0, 1, 2, 3), b, N)
    placed = tmesh.adjoin(loose, mesh, N)
    whole = tmesh.group_tree(placed, (0, 1, 2, 3), b, N)
    assert whole[0].data_ptr() == placed[0][0].data_ptr()
    assert torch.equal(whole[0], x)
    with pytest.raises(ValueError, match="adjacent"):
        tmesh.group_view([placed[1][0], placed[0][0]], (0, 1), b, N)
    # One storage per shard: no full height behind it.
    apart = tmesh.adjoin(loose, mesh, N, groups=tmesh.shard_groups(mesh))
    assert tmesh.group_view([apart[2][0]], (2,), b, N).data_ptr() == \
        apart[2][0].data_ptr()
    with pytest.raises(ValueError, match="full height"):
        tmesh.group_view([apart[2][0]], (2,), b, N, full=True)
    # The views of one group shard back into its blocks.
    views = tmesh.shard_views((whole[0],), (0, 1, 2, 3), b)
    assert [v[0].data_ptr() for v in views] == [p[0].data_ptr() for p in placed]


# -- the sharded CUDA tick's exchange plan and bytes -----------------------

@pytest.mark.parametrize("r", SHARDS)
def test_exchange_plan_moves_only_other_groups_rows(r):
    mesh, b = tmesh.make_mesh(_cpu(r)), N // r
    for key in cg.EXCHANGES:
        assert cg.exchange_plan(key, tmesh.device_groups(mesh), b) == []
    groups = tmesh.shard_groups(mesh)
    for key, names in cg.EXCHANGES.items():
        assert set(names) <= set(cg.MIRRORS)
        plan = cg.exchange_plan(key, groups, b)
        assert len(plan) == len(names) * r * (r - 1)
        for name in names:
            for to in range(r):
                got = sorted((row0, rows) for nm, t, frm, row0, rows in plan
                             if nm == name and t == to)
                assert got == [(f * b, b) for f in range(r) if f != to]
        assert all(frm != to and row0 == frm * b for _, to, frm, row0, _ in plan)
    pairs = cg.exchange_plan("pushpull", ((0, 1), (2, 3)), N // 4)
    assert pairs == [("m_vmid", 0, 1, N // 2, N // 2),
                     ("m_vmid", 1, 0, 0, N // 2)]


def test_exchange_bytes_count_only_rows_across_groups():
    cfg = SimConfig(n=256, view_degree=32)
    st = tlayout.pack(tstate.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    for g in (1, 2, 4, 8):
        groups = tuple((d,) for d in range(g))
        per = {k: cg.exchange_bytes_per_node(k, st, cfg=cfg, groups=groups)
               for k in cg.STAGES}
        # 25 B/node of flags, incarnation and Vivaldi before A, 37 of
        # payloads and pokes before B, 128 of view_mid before C; read and
        # written, once per other group.
        assert per == {"chaos_pre": 0.0, "probe_send": 50.0 * (g - 1),
                       "receive": 74.0 * (g - 1), "pushpull": 256.0 * (g - 1),
                       "serf_post": 0.0, "ref_send": 0.0, "ref_intake": 0.0}
        assert sum(per.values()) == 380 * (g - 1)
