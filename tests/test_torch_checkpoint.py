"""PyTorch port vs the JAX reference: checkpoints
(``consul_tpu_torch/utils/checkpoint.py``, the reference's FORMAT_VERSION
2).

- Round trip: a packed SWIM, a packed serf and a dense-layout state
  restore leaf for leaf, on the template's device, with the meta and
  manifest readable from the header alone.
- Corruption is refused before anything is returned: a flipped payload
  byte (digest), a bad magic, a truncated payload, a template of another
  config; ``verify=False`` skips only the digest.
- Both directions across the packages: the port's file of a reference
  state is the reference's file byte for byte; the reference's dense
  SimState and SerfState checkpoints restore in the port
  (``restore_tree`` + ``convert.py``) equal to the states they saved; the
  port's packed SWIM and serf checkpoints restore in the reference leaf
  for leaf. (The reference's save cannot write bfloat16 or float8 leaves
  here: numpy does not export their buffers, so its packed states are
  carried across in memory.)
- ``state_layout_digest`` equals the reference's for the same packed
  state, and ``restore_widened`` packs a dense-layout checkpoint.
"""

import filecmp

import jax
import numpy as np
import pytest

from consul_tpu.config import SimConfig as JSimConfig
from consul_tpu.models.cluster import SerfSimulation as JSerfSimulation
from consul_tpu.models.cluster import Simulation as JSimulation
from consul_tpu.utils import checkpoint as jck
from consul_tpu_torch import convert
from consul_tpu_torch.config import SimConfig as TSimConfig
from consul_tpu_torch.models import cluster as tcluster
from consul_tpu_torch.models import layout as tlayout
from consul_tpu_torch.models import state as tstate
from consul_tpu_torch.ops import vivaldi as tvivaldi
from consul_tpu_torch.utils import checkpoint as tck

import torch_parity as tp

CFG = dict(n=64, view_degree=8)


def _bits_equal(a, b):
    pa, pb = tck.flatten(a), tck.flatten(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    return all(x.dtype == y.dtype and x.shape == y.shape
               and np.array_equal(convert.bits(x), convert.bits(y))
               for (_, x), (_, y) in zip(pa, pb))


def _port_sim(kind, layout="packed"):
    cls = tcluster.SerfSimulation if kind == "serf" else tcluster.Simulation
    sim = cls(TSimConfig(**CFG), seed=3, kernel="torch", device="cpu",
              layout=layout)
    sim.kill(np.arange(64) < 4)
    sim.run(6, chunk=6, with_metrics=False)
    return sim


@pytest.mark.parametrize("kind,layout", [("swim", "packed"), ("serf", "packed"),
                                         ("swim", "dense")])
def test_round_trip(tmp_path, kind, layout):
    sim = _port_sim(kind, layout)
    path = str(tmp_path / "s.ckpt")
    digest = tck.save(path, sim.state, meta={"t": sim._t, "kind": kind})
    assert tck.read_meta(path) == {"t": sim._t, "kind": kind}
    man = tck.read_manifest(path)
    assert man["sha256"] == digest and man["format_version"] == 2
    assert man["n_leaves"] == len(tck.flatten(sim.state))
    fresh = _port_sim(kind, layout)
    fresh.run(3, chunk=3, with_metrics=False)
    back = tck.restore(path, fresh.state)
    assert type(back) is type(sim.state) and _bits_equal(back, sim.state)
    assert tck.to_host(back).__class__ is type(back)


def test_corruption_refused(tmp_path):
    sim = _port_sim("swim")
    path = tmp_path / "c.ckpt"
    tck.save(str(path), sim.state)
    raw = bytearray(path.read_bytes())
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(bytes(raw[:-3]) + bytes([raw[-3] ^ 0xFF]) + bytes(raw[-2:]))
    with pytest.raises(ValueError, match="digest mismatch"):
        tck.restore(str(bad), sim.state)
    assert _bits_equal(tck.restore(str(bad), sim.state, verify=False)._replace(
        viv=sim.state.viv), sim.state)
    bad.write_bytes(b"XXXX" + bytes(raw[4:]))
    with pytest.raises(ValueError, match="not a checkpoint"):
        tck.restore(str(bad), sim.state)
    bad.write_bytes(bytes(raw[:-10]))
    with pytest.raises(ValueError, match="truncated"):
        tck.restore(str(bad), sim.state)
    bad.write_bytes(bytes(raw[:4]) + (1 << 40).to_bytes(8, "little"))
    with pytest.raises(ValueError, match="manifest length"):
        tck.read_manifest(str(bad))
    other = tcluster.Simulation(TSimConfig(n=128, view_degree=8), seed=3,
                                kernel="torch", device="cpu")
    with pytest.raises(ValueError, match="different SimConfig"):
        tck.restore(str(path), other.state)
    with pytest.raises(ValueError, match="leaves"):
        tck.restore(str(path), _port_sim("serf").state)


def _raw_sim_state(st):
    """A reference dense SimState (numpy) as port tensors in the reference's
    own dtypes, in the port's SimState structure."""
    t = convert.tensor
    return tstate.SimState(
        *[t(x) for x in st[:-3]], tvivaldi.VivaldiState(*[t(x) for x in st.viv]),
        t(st.lat_buf), t(st.lat_cnt))


def test_same_state_same_file(tmp_path):
    jsim = JSimulation(JSimConfig(**CFG), seed=2)
    jsim.run(4, chunk=4, with_metrics=False)
    meta = {"tag": "x", "ticks_done": 4}
    jck.save(str(tmp_path / "j.ckpt"), jsim.state, meta=meta)
    tck.save(str(tmp_path / "t.ckpt"), _raw_sim_state(tp.np_tree(jsim.state)),
             meta=meta)
    assert filecmp.cmp(tmp_path / "j.ckpt", tmp_path / "t.ckpt", shallow=False)


@pytest.mark.parametrize("kind", ["swim", "serf"])
def test_reference_checkpoint_restores_in_port(tmp_path, kind):
    cls = JSerfSimulation if kind == "serf" else JSimulation
    jsim = cls(JSimConfig(**CFG), seed=2)
    jsim.run(4, chunk=4, with_metrics=False)
    path = str(tmp_path / "ref.ckpt")
    jck.save(path, jsim.state, meta={"kind": kind})
    tree = tck.restore_tree(path)
    conv = convert.serf_state_from if kind == "serf" else convert.sim_state_from
    got = conv(tree)
    want = conv(tp.np_tree(jsim.state))
    assert _bits_equal(got, want)
    assert tck.read_meta(path) == {"kind": kind}


@pytest.mark.parametrize("kind", ["swim", "serf"])
def test_port_checkpoint_restores_in_reference(tmp_path, kind):
    cls = JSerfSimulation if kind == "serf" else JSimulation
    jsim = cls(JSimConfig(**CFG), seed=2, layout="packed")
    jsim.run(4, chunk=4, with_metrics=False)
    ref = tp.np_tree(jsim.state)
    conv = convert.serf_state_from if kind == "serf" else convert.packed_state_from
    port = conv(ref)
    assert tck.state_layout_digest(port, 64) == jck.state_layout_digest(
        jsim.state, 64)
    path = str(tmp_path / "port.ckpt")
    tck.save(path, port)
    back = jck.restore(path, jsim.state)
    la, lb = jax.tree.leaves(tp.np_tree(back)), jax.tree.leaves(ref)
    assert len(la) == len(lb) == len(tck.flatten(port))
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(convert.ref_bits(a), convert.ref_bits(b))
    assert jck.read_manifest(path)["names"] == tck.read_manifest(path)["names"]


def test_restore_widened(tmp_path):
    dense = _port_sim("swim", layout="dense")
    path = str(tmp_path / "d.ckpt")
    tck.save(path, dense.state)
    packed = _port_sim("swim")
    tpl = tlayout.unpack_state(packed.state)
    out, prov = tck.restore_widened(path, tpl, tlayout.pack_state, 64)
    assert _bits_equal(out, tlayout.pack(dense.state))
    assert prov == {"widened_from": tck.state_layout_digest(tpl, 64),
                    "widened_to": tck.state_layout_digest(packed.state, 64)}
    assert prov["widened_from"] != prov["widened_to"]
