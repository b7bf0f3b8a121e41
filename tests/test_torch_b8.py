"""B8, the pre-fusion serf oracle inside the CUDA tick
(``cuda_gossip.make_tick_kernel(..., variant="serf_reference")``), and
``Simulation.set_kernel`` (reference cluster.py:566-579), on the CPU.

- B8's wrapper refuses CPU tensors, the fused tick's ``SerfDraws`` (and
  the fused variant refuses ``ReferenceSerfDraws``) and K > 255; its
  operands carry the sweep's columns and loss draws and the ``sref``
  switch; its byte counts per launch are positive (D's zero) and add up
  to at least the tick's state contract plus the sweep's payload.
- ``plain_reference_serf_tick`` is the cluster module's, and
  ``ReferenceSerfSimulation(device="cpu", kernel="torch")`` steps it.
- ``set_kernel`` validates against the layout and the device, maps the
  reference's names (``pallas`` -> ``cuda``, ``xla`` -> ``torch``) and
  raises without a change; rebinding mid-run leaves the run bit-equal,
  for ``Simulation``, ``SerfSimulation`` and ``ReferenceSerfSimulation``.
- On a card (marked ``cuda``; skipped here): B8 against its plain version
  bit for bit over a window with events and a query, a run that toggles
  ``cuda`` / ``torch`` mid-run bit-equal to one that does not, and
  ``ReferenceSerfSimulation`` launching E1 and E2 by default. The module
  imports no JAX, so these run where only PyTorch is installed:
  ``python -m pytest --noconftest -q tests/test_torch_b8.py``.

The plain version against the reference's ``serf.step_reference_counted``
is ``tests/test_torch_serf_reference.py``.
"""

import pytest
import torch

from consul_tpu_torch.config import SerfConfig, SimConfig
from consul_tpu_torch.models import cluster, layout, serf
from consul_tpu_torch.ops import cuda_gossip, topology

CPU = torch.device("cpu")


def _bits(x):
    return x.reshape(-1).contiguous().view(torch.uint8)


def _assert_equal(a, b):
    la, lb = layout.leaves(a), layout.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(_bits(x), _bits(y))


def _tick_inputs(n=64, degree=8, relay=2, loss=0.01, seed=3):
    cfg = SimConfig(n=n, view_degree=degree, packet_loss=loss,
                    serf=SerfConfig(query_relay_factor=relay))
    gen = torch.Generator()
    gen.manual_seed(seed)
    ev_gen = torch.Generator()
    ev_gen.manual_seed(seed + 1)
    world = topology.make_world(cfg, gen, CPU)
    topo = topology.make_topology(cfg, gen, CPU)
    st = layout.pack_state(serf.init(cfg, gen, CPU))
    d = serf.draw_reference_tick(cfg, gen, ev_gen, CPU)
    return cfg, topo, world, st, d, gen


def test_b8_refuses_cpu_tensors_and_other_draws():
    cfg, topo, world, st, d, gen = _tick_inputs()
    k8 = cuda_gossip.make_tick_kernel(cfg, topo, variant="serf_reference")
    assert k8.reference and k8.serf and k8.variant == "serf_reference"
    with pytest.raises(ValueError, match="CUDA tensors"):
        k8(world, st, d)
    fused_draws = serf.draw_serf_tick(cfg, gen, CPU)
    with pytest.raises(TypeError, match="ReferenceSerfDraws"):
        k8.buffer_bytes_per_node(world, st, fused_draws)
    k4 = cuda_gossip.make_tick_kernel(cfg, topo, serf_plane=True)
    with pytest.raises(TypeError, match="SerfDraws"):
        k4.buffer_bytes_per_node(world, st, d)
    with pytest.raises(TypeError, match="draws.ev_u_drop"):
        k8.buffer_bytes_per_node(world, st, d._replace(
            ev_u_drop=d.ev_u_drop.to(torch.float64)))
    with pytest.raises(ValueError, match="unknown tick variant"):
        cuda_gossip.make_tick_kernel(cfg, topo, variant="oracle")


def test_b8_refuses_wide_views():
    cfg = SimConfig(n=512, view_degree=0)
    topo = topology.make_topology(cfg, torch.Generator(), CPU)
    with pytest.raises(ValueError, match="K <= 255"):
        cuda_gossip.make_tick_kernel(cfg, topo, variant="serf_reference")


def test_b8_operands():
    """The sweep's columns and loss draws sit at their TickArgs columns,
    the payload scratch is allocated, the ``sref`` switch is on (off for
    the fused variant) and every pointer column is filled or null."""
    cfg, topo, world, st, d, _ = _tick_inputs()
    k8 = cuda_gossip.make_tick_kernel(cfg, topo, variant="serf_reference")
    out, scratch, tensors = k8._buffers(world, st, d, CPU)
    ptrs = cuda_gossip._PTRS
    assert len(tensors) == len(ptrs)
    assert tensors[ptrs.index("ev_cols")] is d.ev_cols
    assert tensors[ptrs.index("ev_u_drop")] is d.ev_u_drop
    assert {"x_flags", "x_key", "x_orig"} <= set(scratch)
    assert isinstance(out, serf.SerfState)
    ints = cuda_gossip._INTS
    assert k8._args(tensors, None).i[ints.index("sref")] == 1
    k4 = cuda_gossip.make_tick_kernel(cfg, topo, serf_plane=True)
    fused = serf.SerfDraws(*d[:5])
    _, _, t4 = k4._buffers(world, st, fused, CPU)
    assert t4[ptrs.index("ev_cols")] is None
    assert k4._args(t4, None).i[ints.index("sref")] == 0


@pytest.mark.parametrize("chaos_on", [False, True], ids=["quiet", "schedule"])
def test_b8_bytes_per_launch(chaos_on):
    from consul_tpu_torch import chaos

    cfg, topo, world, st, d, gen = _tick_inputs()
    sched = None
    if chaos_on:
        sched = chaos.compile_schedule(cfg.n, [chaos.LinkLoss(
            0, 8, a=slice(0, 8), b=slice(32, 64), fwd=0.5, rev=0.5)])
        d = serf.draw_reference_tick(cfg, gen, gen, CPU, chaos=True)
    out, _ = cuda_gossip.plain_reference_serf_tick(cfg, topo, world, st, d,
                                                   sched)
    stages = ["probe_send", "receive", "pushpull", "ref_send", "ref_intake"]
    per = {s: cuda_gossip.launch_hbm_bytes_per_node(s, st, world, d, sched,
                                                    cfg=cfg, out=out)
           for s in cuda_gossip.STAGES}
    assert all(per[s] > 0 for s in stages)
    assert per["serf_post"] == 0.0
    assert (per["chaos_pre"] > 0) == chaos_on
    contract = (cuda_gossip.tick_hbm_bytes_per_node(st, world, sched)
                + cuda_gossip.sweep_payload_bytes_per_node(cfg))
    assert sum(per.values()) >= contract
    # The fused variant's launches count no sweep.
    fused = serf.SerfDraws(*d[:5])
    assert cuda_gossip.launch_hbm_bytes_per_node(
        "ref_send", st, world, fused, sched, cfg=cfg, out=out) == 0.0
    assert cuda_gossip.sweep_payload_bytes_per_node(cfg) == 2 * (
        2 + 8 * cfg.serf.piggyback_events)


def test_reference_simulation_steps_the_plain_version():
    assert cluster.plain_reference_serf_tick is \
        cuda_gossip.plain_reference_serf_tick
    cfg = SimConfig(n=128, view_degree=8)
    sim = cluster.ReferenceSerfSimulation(cfg, seed=2, device="cpu",
                                          kernel="torch")
    st0 = sim.state
    d = sim.draws(sim._t)
    sim2 = cluster.ReferenceSerfSimulation(cfg, seed=2, device="cpu",
                                           kernel="torch")
    sim2.run(1, chunk=1, with_metrics=False)
    out, _ = cuda_gossip.plain_reference_serf_tick(cfg, sim.topo, sim.world,
                                                   st0, d)
    _assert_equal(out, sim2.state)


def test_set_kernel_validates():
    cfg = SimConfig(n=64, view_degree=8)
    dense = cluster.Simulation(cfg, layout="dense", kernel="torch",
                               device="cpu")
    with pytest.raises(ValueError, match="packed"):
        dense.set_kernel("pallas")
    sim = cluster.Simulation(cfg, kernel="xla", device="cpu")
    assert sim.kernel == "torch"
    with pytest.raises(ValueError, match="CUDA device"):
        sim.set_kernel("cuda")
    with pytest.raises(ValueError, match="unknown kernel"):
        sim.set_kernel("mosaic")
    assert sim.kernel == "torch"
    sim.set_kernel("xla")
    assert sim.kernel == "torch"
    with pytest.raises(ValueError, match="CUDA device"):
        cluster.Simulation(cfg, kernel="pallas", device="cpu")
    assert cuda_gossip.canonical_kernel("pallas") == "cuda"
    assert cuda_gossip.canonical_kernel("cuda") == "cuda"


@pytest.mark.parametrize("cls", [cluster.Simulation, cluster.SerfSimulation,
                                 cluster.ReferenceSerfSimulation],
                         ids=["swim", "serf", "reference"])
def test_set_kernel_toggle_leaves_the_run_bit_equal(cls):
    """Rebinding the engine mid-run (``xla``, then ``torch``) moves
    neither the state, the generators nor the counters."""
    cfg = SimConfig(n=128, view_degree=8, packet_loss=0.01)
    runs = []
    for toggle in (False, True):
        sim = cls(cfg, seed=5, device="cpu", kernel="torch")
        sim.set_lens(4)
        if cls is not cluster.Simulation:
            sim.user_event(torch.arange(cfg.n) == 3, 9)
        sim.run(8, chunk=4, with_metrics=True)
        if toggle:
            sim.set_kernel("xla")
            sim.run(4, chunk=4, with_metrics=False)
            sim.set_kernel("torch")
        else:
            sim.run(4, chunk=4, with_metrics=False)
        sim.run(8, chunk=4, with_metrics=True)
        runs.append(sim)
    a, b = runs
    _assert_equal(a.state, b.state)
    assert a.counters == b.counters
    assert a.generator_state() == b.generator_state()
    (ta, va), (tb, vb) = a.lens.timelines(), b.lens.timelines()
    assert (ta == tb).all() and va.tobytes() == vb.tobytes()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: B8 runs only there")


@pytest.mark.cuda
def test_card_b8_equals_plain():
    _card()
    dev = torch.device("cuda")
    cfg = SimConfig(n=4096, view_degree=16, packet_loss=0.01,
                    serf=SerfConfig(query_relay_factor=2))
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    ev_gen = torch.Generator(device=dev)
    ev_gen.manual_seed(8)
    world = topology.make_world(cfg, gen, dev)
    topo = topology.make_topology(cfg, gen, dev)
    dn = serf.init(cfg, gen, dev)
    for j, row in enumerate((5, 1000, 4095)):
        dn = serf.user_event(cfg, dn, torch.arange(cfg.n, device=dev) == row,
                             11 + j)
    dn = serf.query(cfg, dn, torch.arange(cfg.n, device=dev) == 77, 3)
    k8 = cuda_gossip.make_tick_kernel(cfg, topo, variant="serf_reference")
    kp = pp = layout.pack_state(dn)
    for _ in range(16):
        d = serf.draw_reference_tick(cfg, gen, ev_gen, dev)
        kp, kc = k8(world, kp, d)
        pp, pc = cuda_gossip.plain_reference_serf_tick(cfg, topo, world, pp, d)
        assert torch.equal(kc, pc)
        _assert_equal(kp, pp)


@pytest.mark.cuda
def test_card_set_kernel_toggle():
    _card()
    cfg = SimConfig(n=4096, view_degree=16)
    runs = []
    for toggle in (False, True):
        sim = cluster.ReferenceSerfSimulation(cfg, seed=4)
        sim.user_event(torch.arange(cfg.n) == 3, 9)
        sim.run(16, chunk=8, with_metrics=False)
        if toggle:
            sim.set_kernel("torch")
        sim.run(8, chunk=8, with_metrics=False)
        sim.set_kernel("pallas")
        sim.run(8, chunk=8, with_metrics=False)
        runs.append(sim)
    _assert_equal(runs[0].state, runs[1].state)
    assert runs[0].counters == runs[1].counters


@pytest.mark.cuda
def test_card_oracle_runs_on_b8():
    """On a card ``ReferenceSerfSimulation`` takes ``kernel="cuda"`` by
    default: its ticks launch E1 and E2 (B8) and never D."""
    _card()
    cfg = SimConfig(n=4096, view_degree=16)
    sim = cluster.ReferenceSerfSimulation(cfg, seed=1)
    assert sim.kernel == "cuda"
    before = dict(cuda_gossip.LAUNCHES)
    sim.user_event(torch.arange(cfg.n) == 3, 9)
    sim.run(4, chunk=4, with_metrics=False)
    after = cuda_gossip.LAUNCHES
    assert after["ref_send"] - before["ref_send"] == 4
    assert after["ref_intake"] - before["ref_intake"] == 4
    assert after["serf_post"] == before["serf_post"]
