"""The port's sparse network core against the JAX package: topologies,
neighbour lists and degree buckets (exact), cost families (rtol 1e-6;
1e-5 for the cube family, whose power differs by an ulp between the
frameworks), shortest-path-tree φ⁰ (exact, both the Floyd-Warshall and
the Dijkstra branch), flows and marginals on the same scenario arrays
(rtol 1e-5), and the port's bitwise padded ≡ bucketed contract.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import costs as jcosts
from repro.core import network as jnetwork
from repro.core import topologies as jtopo
from repro_torch import core as tcore
from repro_torch.convert import (network_from_numpy, network_to_numpy,
                                 phi_sparse_from_numpy, phi_sparse_to_numpy)
from repro_torch.core import costs as tcosts
from repro_torch.core import network as tnetwork
from test_torch_sgp import jax_net

torch.set_num_threads(1)

RTOL = dict(rtol=1e-5, atol=1e-6)


@jax.jit
def j_flows_and_marginals(jn, jphi, jnb):
    """The reference's flows, carry + cost and slot-F marginals of one
    iterate, traced into one program (one compile a scenario)."""
    carry, cost = jcore.flows_carry_and_cost(jn, jphi, "sparse", nbrs=jnb)
    return (jcore.compute_flows(jn, jphi, "sparse", nbrs=jnb), carry, cost,
            jcore.compute_marginals(jn, jphi, carry, "sparse", nbrs=jnb,
                                    slot_F=True))


@pytest.mark.parametrize("name,kw", [
    ("connected_er", dict(V=20, seed=3)), ("balanced_tree", {}), ("fog", {}),
    ("abilene", {}), ("lhc", {}), ("geant", {}),
    ("small_world", dict(V=60, n_short=60, n_long=70, seed=2)),
    ("barabasi_albert", dict(V=300, m=2, seed=1)), ("grid", dict(side=7))])
def test_topologies_match(name, kw):
    np.testing.assert_array_equal(tcore.topologies.TOPOLOGIES[name](**kw),
                                  jtopo.TOPOLOGIES[name](**kw))


def _ba(V=120, seed=3):
    return jtopo.barabasi_albert(V=V, m=2, seed=seed)


@pytest.mark.parametrize("adj", [jtopo.fog(), _ba()], ids=["fog", "ba"])
def test_neighbors_and_buckets_match(adj):
    nb, jnb = tcore.build_neighbors(adj, device="cpu"), \
        jcore.build_neighbors(adj)
    for f in ("out_nbr", "out_mask", "in_nbr", "in_slot", "in_mask"):
        np.testing.assert_array_equal(getattr(nb, f).numpy(),
                                      np.asarray(getattr(jnb, f)),
                                      err_msg=f)
    bk, jbk = tcore.build_buckets(adj, device="cpu"), \
        jcore.build_buckets(adj)
    for d in ("out", "inn"):
        eb, jeb = getattr(bk, d), getattr(jbk, d)
        # the port lays the reference's per-bucket tiles end to end
        assert eb.widths == tuple(int(t.shape[1]) for t in jeb.nbr)
        np.testing.assert_array_equal(np.argsort(eb.nodes.numpy()),
                                      np.asarray(jeb.inv))
        for f in ("nodes", "nbr", "wsrc", "wslot", "mask"):
            want = np.concatenate([np.asarray(t).reshape(-1)
                                   for t in getattr(jeb, f)])
            np.testing.assert_array_equal(getattr(eb, f).numpy(),
                                          want.astype(getattr(eb, f).numpy()
                                                      .dtype), err_msg=f)
        assert eb.lanes == jeb.lanes == int(eb.lane_off[-1])
    assert tcore.build_neighbors(adj, device="cpu") is nb     # memoized


@pytest.mark.parametrize("family", ["linear", "queue", "power"])
def test_cost_families_match(family):
    rng = np.random.default_rng(0)
    cap = (rng.random(200) * 20 + 1).astype(np.float32)
    F = (rng.random(200) * 1.2 * cap).astype(np.float32)   # past the knee
    T0 = np.float32(3.7)
    t = tcosts.Cost(family, torch.from_numpy(cap))
    j = jcosts.Cost(family, jnp.asarray(cap))
    tol = dict(rtol=1e-5) if family == "power" else dict(rtol=1e-6)
    for fn in ("value", "d1", "d2"):
        np.testing.assert_allclose(
            getattr(t, fn)(torch.from_numpy(F)).numpy(),
            np.asarray(getattr(j, fn)(jnp.asarray(F))), err_msg=fn, **tol)
    np.testing.assert_allclose(t.d2_sup(torch.tensor(T0)).numpy(),
                               np.asarray(j.d2_sup(jnp.asarray(T0))), **tol)


def _random_net(adj, S=6, seed=0):
    rng = np.random.default_rng(seed)
    V = adj.shape[0]
    r = np.zeros((S, V))
    r[:, :4] = rng.random((S, 4))
    return network_from_numpy(
        adj, np.where(adj, rng.random((V, V)) * 10 + 1, 1.0),
        rng.random(V) * 10 + 1, rng.integers(0, V, S), r, rng.random(S),
        rng.random((S, V)) + 1, np.zeros(S), "queue", "queue", device="cpu")


@pytest.mark.parametrize("V", [40, 260], ids=["floyd", "dijkstra"])
def test_spt_slots_match(V):
    """Shortest-path-tree φ⁰ rows, on both sides of DENSE_V_LIMIT."""
    net = _random_net(_ba(V, seed=4))
    nb = tcore.build_neighbors(net.adj)
    got = tcore.spt_result_slots(net, nb)
    jn = jax_net(net)
    want = jnetwork.spt_result_slots(jn, jcore.build_neighbors(jn.adj))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_convert_roundtrip():
    net = _random_net(_ba(30))
    back = network_from_numpy(
        **{k: v for k, v in network_to_numpy(net).items()}, device="cpu")
    for f in ("adj", "dest", "r", "a", "w", "task_type"):
        assert torch.equal(getattr(net, f), getattr(back, f))
    assert torch.equal(net.link_cost.params, back.link_cost.params)
    phi = tcore.spt_phi_sparse(net)
    again = phi_sparse_from_numpy(*phi_sparse_to_numpy(phi), device="cpu")
    assert torch.equal(phi.result, again.result)


def test_slot_gather_scatter_roundtrip():
    net = _random_net(_ba(50))
    nb = tcore.build_neighbors(net.adj)
    phi = tcore.spt_phi_sparse(net, nb)
    dense = tcore.sparse_to_phi(phi, nb)
    back = tcore.phi_to_sparse(dense, nb)
    for a, b in zip(phi_sparse_to_numpy(phi), phi_sparse_to_numpy(back)):
        np.testing.assert_array_equal(a, b)


def _mixed_phi(net, nb):
    """A loop-free iterate that forwards half the data along the
    shortest-path tree and computes the rest locally."""
    phi0 = tcore.spt_phi_sparse(net, nb)
    data = 0.5 * phi0.result
    return tcore.PhiSparse(data, 1.0 - data.sum(-1, keepdim=True),
                           phi0.result)


@pytest.mark.parametrize("name", ["fog", "lhc", "sw_queue"])
def test_flows_and_marginals_match(name):
    net = tcore.make_scenario(tcore.TABLE_II[name], device="cpu")
    nb = tcore.build_neighbors(net.adj)
    phi = _mixed_phi(net, nb)
    jn = jax_net(net)
    jnb = jcore.build_neighbors(jn.adj)
    jphi = jcore.PhiSparse(*(jnp.asarray(a)
                             for a in phi_sparse_to_numpy(phi)))
    jfl, jcarry, jcost, jmg = j_flows_and_marginals(jn, jphi, jnb)
    fl = tcore.compute_flows(net, phi, nbrs=nb)
    for f in ("t_data", "t_result", "g", "F", "G"):
        np.testing.assert_allclose(getattr(fl, f).numpy(),
                                   np.asarray(getattr(jfl, f)), err_msg=f,
                                   **RTOL)
    carry, cost = tcore.flows_carry_and_cost(net, phi, nbrs=nb)
    np.testing.assert_allclose(carry.F.numpy(), np.asarray(jcarry.F), **RTOL)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-5)
    mg = tcore.compute_marginals(net, phi, carry, nbrs=nb, slot_F=True)
    for f in ("rho_data", "rho_result", "delta_data", "delta_result", "Dp",
              "Cp"):
        np.testing.assert_allclose(getattr(mg, f).numpy(),
                                   np.asarray(getattr(jmg, f)), err_msg=f,
                                   **RTOL)


def test_bucketed_flows_marginals_blocked_bitwise():
    """Degree buckets change nothing in flows, marginals or blocked sets."""
    spec = tcore.ScenarioSpec("barabasi_albert", 150, 6, 5, 5, "queue",
                              "queue", 30, 30)
    net = tcore.make_scenario(spec, device="cpu")
    nb, bk = tcore.build_neighbors(net.adj), tcore.build_buckets(net.adj)
    phi = _mixed_phi(net, nb)
    out = []
    for buckets in (None, bk):
        carry, cost = tcore.flows_carry_and_cost(net, phi, nbrs=nb,
                                                 buckets=buckets)
        mg = tcore.compute_marginals(net, phi, carry, nbrs=nb, slot_F=True,
                                     buckets=buckets)
        perm = tcore.blocked_sets_sparse(net, phi, mg, nb, buckets=buckets)
        out.append((carry.t_data, carry.t_result, carry.F, carry.G, cost,
                    mg.rho_data, mg.rho_result, mg.delta_data, *perm))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_make_scenario_defaults_to_the_card():
    """Without device= the scenario goes to "cuda": on a CPU-only build
    that raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        tcore.make_scenario(tcore.TABLE_II["abilene"])
    assert tnetwork.DENSE_V_LIMIT == jnetwork.DENSE_V_LIMIT
