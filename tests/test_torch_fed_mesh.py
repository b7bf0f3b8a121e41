"""The federation and the DCN tier on a mesh (``Federation(mesh=)``,
``DcnFederation(meshes=)``; the reference's ``federation_sharding``,
consul_tpu/parallel/mesh.py:174-197, and tests/test_dcn.py:189-211), on
the CPU's plain path (``kernel="torch"``).

- ``Federation`` on ``["cpu"] * 4`` as a (2, 2) (dc, nodes) mesh at 4 DCs
  x 32 nodes and on ``["cpu"] * 2`` as (2, 1) at 2 DCs x 64 nodes, under
  the row's device groups and under one group per shard: at every chunk
  boundary (a node of dc0 killed and the last DC killed whole after the
  first) every leaf of every pool equals the one-device federation's bit
  for bit, and so do ``counters()``, ``lan_health`` and the WAN read-outs.
  The one-device federation is the one tests/test_torch_federation.py
  holds to the reference.
- ``DcnFederation(meshes=)`` in tests/test_dcn.py:189-211's shape (4 DCs
  x 32 nodes, 2 islands) on two (2, 1) meshes, 12 sync rounds of 8 ticks
  under bench.py's link faults: every island equals the meshless run's,
  bit for bit, with the same link envelope; every LAN block lies on its
  island's mesh, and the replicas agree.
- Wrong meshes raise: no dc axis, rows that do not divide the DCs, a row
  width that does not divide a DC's nodes, a device other than the
  mesh's first, a grouping that does not cover a row; and
  ``kernel="cuda"`` on a mesh of CPU devices (no fallback).
"""

import pytest
import torch

from consul_tpu_torch.config import SimConfig
from consul_tpu_torch.models import federation as fed_mod
from consul_tpu_torch.models import layout
from consul_tpu_torch.parallel import dcn
from consul_tpu_torch.parallel import mesh as mesh_mod
from consul_tpu_torch.utils.telemetry import Sink

torch.set_num_threads(1)

CHUNK, CHUNKS = 8, 3
# (devices, rows, DCs, nodes per DC)
MESHES = {"2x2": (4, 2, 4, 32), "2x1": (2, 2, 2, 64)}


def _cfg(n_dc, nodes, servers=3, view=8):
    return fed_mod.FederationConfig(n_dc=n_dc, nodes_per_dc=nodes,
                                    servers_per_dc=servers,
                                    lan=SimConfig(view_degree=view))


def _bits(x):
    return x.reshape(-1).view(torch.uint8) if x.dim() else x.reshape(1)


def _assert_pool_equal(a, b, where):
    for i, (x, y) in enumerate(zip(layout.leaves(a), layout.leaves(b))):
        assert x.dtype == y.dtype and x.shape == y.shape, (where, i)
        assert torch.equal(_bits(x), _bits(y)), f"{where}: leaf {i}"


def _assert_fed_equal(meshed, one, where):
    got, want = meshed.whole_state(), one.state
    assert got.wan_accum_ms == want.wan_accum_ms, where
    for i, (a, b) in enumerate(zip(got.lan, want.lan)):
        _assert_pool_equal(a, b, f"{where} lan{i}")
    _assert_pool_equal(got.wan, want.wan, f"{where} wan")
    assert meshed.counters() == one.counters(), where


def _groups(mesh, grouping):
    row = mesh_mod.row_mesh(mesh, 0)
    return None if grouping == "device" else mesh_mod.shard_groups(row)


@pytest.mark.parametrize("grouping", ("device", "shard"))
@pytest.mark.parametrize("shape", sorted(MESHES))
def test_meshed_federation_is_bit_equal_to_one_device(shape, grouping):
    devices, rows, n_dc, nodes = MESHES[shape]
    cfg = _cfg(n_dc, nodes)
    mesh = mesh_mod.make_mesh(["cpu"] * devices, n_dc=rows)
    meshed = fed_mod.Federation(cfg, seed=4, mesh=mesh,
                                groups=_groups(mesh, grouping), device="cpu",
                                kernel="torch")
    one = fed_mod.Federation(cfg, seed=4, device="cpu", kernel="torch")
    assert meshed.device == one.device
    for c in range(CHUNKS):
        if c == 1:
            for f in (meshed, one):
                f.kill(0, torch.arange(nodes) == 5)
                f.kill_dc(n_dc - 1)
        for f in (meshed, one):
            f.run(CHUNK, chunk=CHUNK)
        _assert_fed_equal(meshed, one, f"chunk {c}")
    for dc in range(n_dc):
        assert meshed.lan_health(dc) == one.lan_health(dc)
        assert meshed.wan_members_seen_by(dc) == one.wan_members_seen_by(dc)
        assert meshed.true_dc_distance_order(dc) == one.true_dc_distance_order(dc)
    assert meshed.wan_health() == one.wan_health()
    # Each DC's blocks lie on its row's devices, one block a shard.
    per = n_dc // rows
    for dc, blocks in enumerate(meshed.state.lan):
        row = mesh_mod.row_mesh(mesh, dc // per)
        assert len(blocks) == row.size
        for blk, dev in zip(blocks, row.devices):
            assert all(x.device == dev for x in layout.leaves(blk))
    assert mesh_mod.federation_rows(mesh, n_dc, nodes) == tuple(
        dc // per for dc in range(n_dc))


def _drill(meshes, groups=None):
    d = dcn.DcnFederation(_cfg(4, 32), n_islands=2, seed=0, meshes=meshes,
                          sink=Sink(), groups=groups,
                          link_policy=dcn.LinkPolicy(retry_max=3,
                                                     queue_bound=4),
                          device="cpu", kernel="torch")
    d.inject_link_faults([
        dcn.LinkFault(src=0, dst=1, start=1, stop=4, kind="timeout"),
        dcn.LinkFault(src=1, dst=0, start=1, stop=4)])
    d.run(96, sync_every=8, chunk=8)
    return d


def _envelope(d):
    return ({ab: (ls.attempt, ls.down_until, ls.degraded, ls.queue_peak,
                  len(ls.queue)) for ab, ls in d._links.items()},
            {c: d.sink.counter_sum("sim.dcn." + c)
             for c in ("retries", "link_down_ticks", "send_timeouts",
                       "retx_dropped", "heals", "link_degraded")})


def test_dcn_on_meshes_is_bit_equal_to_meshless():
    meshes = [mesh_mod.make_mesh(["cpu"] * 2, n_dc=2) for _ in range(2)]
    meshed, flat = _drill(meshes), _drill(None)
    for k, (a, b) in enumerate(zip(meshed.islands, flat.islands)):
        assert a.mesh is meshes[k] and a.device == meshes[k].devices[0]
        _assert_fed_equal(a, b, f"island {k}")
        for blocks in a.state.lan:
            for blk in blocks:
                assert all(x.device in meshes[k].devices
                           for x in layout.leaves(blk))
    assert _envelope(meshed) == _envelope(flat)
    assert _envelope(meshed)[1]["heals"] == 2
    assert meshed.replicas_agree() and flat.replicas_agree()


@pytest.mark.parametrize("case", ("no_dc_axis", "rows_vs_dcs", "width_vs_nodes",
                                  "device", "groups", "cuda_on_cpu"))
def test_wrong_meshes_raise(case):
    cfg = _cfg(4, 32)
    kw = dict(seed=0, device="cpu", kernel="torch")
    if case == "cuda_on_cpu":
        # No fallback: the CUDA tick on a mesh of CPU devices raises, for a
        # federation and for a DCN island alike.
        m = mesh_mod.make_mesh(["cpu"] * 2, n_dc=2)
        with pytest.raises(ValueError, match="CUDA device"):
            fed_mod.Federation(cfg, mesh=m, seed=0, device="cpu", kernel="cuda")
        with pytest.raises(ValueError, match="CUDA device"):
            dcn.DcnFederation(cfg, n_islands=2, meshes=[m, m], device="cpu",
                              kernel="cuda")
        return
    if case == "no_dc_axis":
        args, match = dict(mesh=mesh_mod.make_mesh(["cpu"] * 2)), "2-D"
    elif case == "rows_vs_dcs":
        args, match = dict(mesh=mesh_mod.make_mesh(["cpu"] * 3, n_dc=3)), "rows"
    elif case == "width_vs_nodes":
        args, match = dict(mesh=mesh_mod.make_mesh(["cpu"] * 6, n_dc=2)), "divide"
    elif case == "device":
        args = dict(mesh=mesh_mod.make_mesh(["meta"] * 2, n_dc=2))
        match = "first device"
    else:
        args = dict(mesh=mesh_mod.make_mesh(["cpu"] * 4, n_dc=2),
                    groups=((0,),))
        match = "consecutive runs"
    with pytest.raises(ValueError, match=match):
        fed_mod.Federation(cfg, **args, **kw)
