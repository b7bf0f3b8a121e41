"""Check that ``jax_disable_most_optimizations`` leaves the reference's
results as they are.

The port's parity modules compile the reference's programs with the flag
on (``torch_parity.quick_reference_compiles``). This script runs a few of
those reference oracles once with the flag off and once with it on, each
in a process of its own, and compares every output array bit for bit:

- the Pallas tick in interpret mode (``pallas_gossip.interpret_tick``),
  4 ticks at n = 256, K = 16 with 2 % loss after a kill, and 10 ticks of
  the serf tick under a fault schedule with the sentinel on the dense
  view at n = 64;
- ``Simulation.run_scenario`` of the bench's partition-heal probe at
  n = 1024 (state, SLO and counters);
- ``Federation.run`` (3 DCs x 48 nodes: 60 ticks, a kill and a DC kill,
  150 ticks) and the packed-codec federation oracle
  (``torch_parity.fed_oracle``) over the same 210 ticks.

Run from the repository's root: ``python tests/reference_flag_check.py``
(about five minutes). It runs the flag off twice and on once, prints for
each pair of runs compared (off against off, off against on) how many
arrays are bit-equal and, for each that is not, its dtype, how many
elements differ and by how much, and exits 1 if any differs.
"""

import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))


def collect(flag: bool, out: str):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)
    jax.config.update("jax_disable_most_optimizations", flag)

    from consul_tpu.chaos import schedule as jchaos
    from consul_tpu.models import cluster as jcluster
    from consul_tpu.models import federation as jfed_mod
    from consul_tpu.models import layout as jlayout
    from consul_tpu.models import serf as jserf
    from consul_tpu.ops import pallas_gossip

    import torch_parity as tp

    got = {}

    def keep(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            got[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)

    # interpret_tick, bare sparse.
    jcfg, _, world, topo, st = tp.setup(256, 16, packet_loss=0.02)
    kill = np.zeros(256, bool)
    kill[:13] = True
    st = st._replace(alive_truth=st.alive_truth & ~kill)
    tick = jax.jit(pallas_gossip.interpret_tick(jcfg, topo))
    kp = jlayout.pack_state(st)
    for t in range(4):
        kp, kc = tick(world, None, kp, jax.random.fold_in(jax.random.PRNGKey(17), t))
        keep(f"interpret/{t}", (kp, kc))

    # interpret_tick, serf x chaos x sentinel on the dense view.
    n = 64
    jcfg, _, world, topo, st = tp.setup(n, 0, packet_loss=0.01)
    st = jserf.init(jcfg, jax.random.PRNGKey(4))._replace(swim=st)
    ev = np.zeros(n, bool)
    ev[[20, 50]] = True
    st = jserf.user_event(jcfg, st, ev, 7)
    st = jserf.query(jcfg, st, np.arange(n) == 5, 3)
    st = st._replace(swim=st.swim._replace(
        alive_truth=st.swim.alive_truth & ~(np.arange(n) < 8)))
    js = jchaos.compile_schedule(n, [
        jchaos.Partition(1, 10, slice(0, n // 4)),
        jchaos.ChurnWave(1, 20, slice(n // 2, n // 2 + 4), period=4,
                         down_ticks=2),
        jchaos.Degrade(0, 14, slice(n - n // 8, n), tx_loss=0.4)])
    tick = jax.jit(pallas_gossip.interpret_tick(
        jcfg, topo, step_fn=jserf.step_counted, sentinel=True))
    kp = jlayout.pack_state(st)
    for t in range(10):
        kp, kc = tick(world, js, kp, jax.random.fold_in(jax.random.PRNGKey(31), t))
        keep(f"serf_dense/{t}", (kp, kc))

    # run_scenario.
    jcfg, _ = tp.configs(n=1024, view_degree=32)
    jsim = jcluster.Simulation(jcfg, seed=0, layout="packed")
    jsim.run(64, chunk=32, with_metrics=False)
    rep = jsim.run_scenario([jchaos.Partition(start=4, stop=16,
                                              side_a=slice(0, 307))],
                            chunk=32, settle=64)
    keep("scenario/state", jsim.state)
    got["scenario/slo"] = np.asarray(repr(sorted(rep.slo.items())))
    got["scenario/counters"] = np.asarray(repr(sorted(rep.counters.items())))

    # Federation.run and the federation oracle.
    jcfg, _ = tp.fed_configs(n_dc=3, nodes_per_dc=48, servers_per_dc=3)
    jfed = jfed_mod.Federation(jcfg, seed=4)
    oracle = tp.fed_oracle(jcfg, jfed.lan_topo, jfed.wan_topo)
    ost = oracle.start(jfed.state)
    victim = np.arange(48) == 10
    for t in range(210):
        if t == 60:
            jfed.kill(0, victim)
            jfed.kill_dc(2)
            lan = ost.lan
            at = lan.alive_truth.at[0].set(lan.alive_truth[0] & ~victim)
            at = at.at[2].set(False)
            wat = ost.wan.alive_truth.at[0:3].set(ost.wan.alive_truth[0:3]
                                                  & ~victim[:3])
            wat = wat.at[6:9].set(False)
            ost = ost._replace(lan=lan._replace(alive_truth=at),
                               wan=ost.wan._replace(alive_truth=wat))
        ost, lc, wc = oracle(jfed.lan_world, jfed.wan_world, ost,
                             jax.random.fold_in(jfed.base_key, t))
        if t % 30 == 29:
            keep(f"oracle/{t}", (ost, lc, wc))
    jfed.run(60, chunk=30)
    jfed.kill(0, victim)
    jfed.kill_dc(2)
    jfed.run(150, chunk=30)
    keep("federation/state", jfed.state)
    np.savez(out, **got)
    print(f"flag={flag}: {len(got)} arrays", flush=True)


def compare(a, b) -> list:
    """The arrays of two runs that differ, each with its dtype, the number
    of elements that differ and the largest difference (for floats, also
    in units of the larger value's f32 spacing)."""
    import numpy as np

    if set(a.files) != set(b.files):
        return ["the two runs kept different arrays"]
    bad = []
    for k in sorted(a.files):
        x, y = a[k], b[k]
        if x.dtype == y.dtype and x.shape == y.shape and \
                x.tobytes() == y.tobytes():
            continue
        line = f"{k}: {x.dtype}"
        if x.shape == y.shape and x.dtype.kind in "fiu":
            xf, yf = x.astype(np.float64), y.astype(np.float64)
            ne = ~((xf == yf) | (np.isnan(xf) & np.isnan(yf)))
            d = np.abs(xf - yf)[ne]
            line += f", {int(ne.sum())} of {x.size} differ, max |d| {d.max():.3g}"
            if x.dtype.kind == "f":
                ulp = np.spacing(np.maximum(np.abs(xf), np.abs(yf))
                                 .astype(np.float32))[ne].astype(np.float64)
                line += f" ({(d / ulp).max():.3g} f32 ulps)"
        bad.append(line)
    return bad


def main() -> int:
    import numpy as np

    with tempfile.TemporaryDirectory() as d:
        runs = (("off", False), ("off again", False), ("on", True))
        paths = []
        for name, flag in runs:
            paths.append(os.path.join(d, f"{len(paths)}.npz"))
            subprocess.run([sys.executable, __file__, str(int(flag)),
                            paths[-1]], check=True)
        off, again, on = (np.load(p) for p in paths)
        rc = 0
        for what, x, y in (("off against off", off, again),
                           ("off against on", off, on)):
            bad = compare(x, y)
            print(f"{what}: {len(x.files) - len(bad)} of {len(x.files)} "
                  "arrays bit-equal", flush=True)
            for line in bad:
                print("  " + line)
            rc |= bool(bad)
        return int(rc)


if __name__ == "__main__":
    if len(sys.argv) == 3:
        collect(bool(int(sys.argv[1])), sys.argv[2])
    else:
        sys.exit(main())
