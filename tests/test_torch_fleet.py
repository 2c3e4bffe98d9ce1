"""The batched fleet on the port (`repro_torch.core.fleet`) against the JAX
package's `repro.core.fleet`.

Every lane of a B = 8 abilene fleet (the reference test's `_fleet_nets`
perturbations: rates, destinations and result ratios drawn with numpy
from seed 0) is bit for bit its solo port run (`run_chunk(driver=
"fused")`), and the lanes' costs hold to `repro.core.run_fleet`'s at
rtol 2e-4, against `src/repro_torch/data/reference_robust.json`, written
by

    PYTHONPATH=src python tests/test_torch_fleet.py --write-golden

(the reference's vmapped step compiles for ~10 s on one core).  The
dispatches do not depend on B, the warm cache round-trips, cache keys
separate and join scenarios as the reference's do, and mixed topologies
and paper scaling raise.
"""
import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import fleet as jfleet
from repro_torch import core as tcore
from repro_torch.core import fleet as tfleet
from repro_torch.core import sgp
from test_torch_faults import nets
from test_torch_sgp import jax_net

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch",
                    "data")
ROBUST = os.path.join(DATA, "reference_robust.json")
B = 8
N_ITERS = 10


def fleet_nets(b=B, seed=0):
    """B abilene variants on one adjacency: rates, destinations and result
    ratios perturbed from `seed`, as the reference's fleet test draws
    them."""
    base = nets("abilene")[0]
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(b):
        r = base.r.numpy() * (0.6 + 0.8 * rng.rand(*base.r.shape))
        dest = rng.randint(0, base.V, size=tuple(base.dest.shape))
        a = base.a.numpy() * (0.5 + rng.rand(*base.a.shape))
        out.append(dataclasses.replace(
            base, r=torch.tensor(r, dtype=torch.float32),
            dest=torch.tensor(dest, dtype=torch.int64),
            a=torch.tensor(a, dtype=torch.float32)))
    return out


def write_golden(path=ROBUST):
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    jnets = [jax_net(n) for n in fleet_nets()]
    _, hist = jcore.run_fleet(jnets, n_iters=N_ITERS)
    out["fleet_abilene"] = {
        "B": B, "n_iters": N_ITERS,
        "costs": [[float(c) for c in lane] for lane in hist["costs"]],
        "stopped": [bool(s) for s in hist["stopped"]],
        "source": ("repro.core.run_fleet(nets, n_iters=10) on the B = 8 "
                   "abilene fleet of tests/test_torch_fleet.py::fleet_nets"
                   ", on the CPU: PYTHONPATH=src python tests/"
                   "test_torch_fleet.py --write-golden")}
    with open(path, "w") as f:
        json.dump(out, f)
        f.write("\n")


def solo(net, nbrs, phi0=None, n_iters=N_ITERS):
    phi0 = tcore.spt_phi_sparse(net, nbrs) if phi0 is None else phi0
    st = tcore.init_run_state(net, phi0, method="sparse", nbrs=nbrs)
    return tcore.run_chunk(net, st, n_iters, driver="fused")


@pytest.fixture(scope="module")
def fleet():
    fnets = fleet_nets()
    nbrs = tcore.build_neighbors(fnets[0].adj)
    return fnets, nbrs, tcore.run_fleet(fnets, n_iters=N_ITERS, nbrs=nbrs)


def test_fleet_lanes_are_their_solo_runs(fleet):
    """Each lane's accepted costs and final φ are its solo fused run's,
    bit for bit."""
    fnets, nbrs, (phis, hist) = fleet
    assert len(phis) == B and hist["stopped"] == [False] * B
    for b, net in enumerate(fnets):
        ref = solo(net, nbrs)
        assert hist["costs"][b] == ref.costs, f"lane {b}"
        assert all(torch.equal(x, y) for x, y in
                   zip(sgp._fields(phis[b]), sgp._fields(ref.phi))), b


def test_fleet_matches_reference(fleet):
    """Each lane's accepted costs against `repro.core.run_fleet`'s."""
    with open(ROBUST) as f:
        want = json.load(f)["fleet_abilene"]
    _, _, (_, hist) = fleet
    assert want["B"] == B and want["n_iters"] == N_ITERS
    for b in range(B):
        assert len(hist["costs"][b]) == len(want["costs"][b]), b
        np.testing.assert_allclose(hist["costs"][b], want["costs"][b],
                                   rtol=2e-4, err_msg=f"lane {b}")
    assert hist["stopped"] == want["stopped"]


def test_fleet_dispatches_do_not_depend_on_B():
    """One dispatch an iteration for the whole fleet (the reference's
    vmapped driver counts two: a propose and an accept)."""
    nbrs = tcore.build_neighbors(nets("abilene")[0].adj)
    for b in (1, 4):
        _, hist = tcore.run_fleet(fleet_nets(b), n_iters=3, nbrs=nbrs)
        assert hist["n_dispatches"] == 3


def test_fleet_warm_cache_roundtrip(fleet):
    """A recurring task pattern re-enters at its converged φ: the second
    solve is all cache hits, starts at the first solve's final cost and
    never rises above it."""
    fnets, nbrs, (phis, cold) = fleet
    cache = tcore.FleetCache()
    for net, phi in zip(fnets, phis):
        cache.put(net, phi)
    assert len(cache) == B
    _, warm = tcore.run_fleet(fnets, n_iters=4, nbrs=nbrs, cache=cache)
    assert warm["warm"] == [True] * B and cache.hits == B
    for b in range(B):
        assert warm["costs"][b][0] == cold["costs"][b][-1]
        assert min(warm["costs"][b]) <= cold["costs"][b][-1]
    miss = tcore.FleetCache()
    assert miss.get(fnets[0]) is None and miss.misses == 1


def test_fleet_cache_keys_separate_like_the_reference():
    """Equal keys for a clone, different ones for another lane, a rate
    one float32 step up and another pool mask, in the port as in the
    reference (whose keys hash int32 indices where the port's hash
    int64, so the keys themselves differ)."""
    tn = fleet_nets(2)
    jn = [jax_net(n) for n in tn]
    act = np.ones(tn[0].S, bool)
    act[3] = False

    def variants(nets_, key, asarray):
        base = nets_[0]
        return [key(base), key(dataclasses.replace(base)), key(nets_[1]),
                key(dataclasses.replace(base, r=base.r * asarray(1.0000001))),
                key(base, active=act)]

    got = variants(tn, tfleet.fleet_cache_key, torch.tensor)
    want = variants(jn, jfleet.fleet_cache_key, jnp.float32)
    assert [[a == b for b in got] for a in got] == \
        [[a == b for b in want] for a in want]
    assert got[0] == got[1] and len({k for k in got}) == 4


def test_fleet_errors_and_explicit_phi0():
    """Mixed topologies, mixed cost families and paper scaling raise; a
    caller's dense φ⁰ (converted to slots) wins over the cache."""
    tn = fleet_nets(2)
    adj = tn[1].adj.clone()
    i, j = torch.nonzero(adj)[0].tolist()
    adj[i, j] = False
    with pytest.raises(ValueError, match="different adjacency"):
        tcore.stack_fleet([tn[0], dataclasses.replace(tn[1], adj=adj)])
    mixed = dataclasses.replace(
        tn[1], link_cost=tcore.Cost("linear", tn[1].link_cost.params))
    with pytest.raises(ValueError, match="cost families"):
        tcore.stack_fleet([tn[0], mixed])
    nbrs = tcore.build_neighbors(tn[0].adj)
    phi0s = [tcore.offload_phi(net, list(range(4))) for net in tn]
    _, hist = tcore.run_fleet(tn, n_iters=3, phi0s=phi0s, nbrs=nbrs)
    assert hist["warm"] == [False, False]
    for b, net in enumerate(tn):
        ref = solo(net, nbrs, tcore.phi_to_sparse(phi0s[b], nbrs), 3)
        assert hist["costs"][b] == ref.costs
    state = tcore.init_fleet_state(tn, nbrs=nbrs)
    with pytest.raises(NotImplementedError, match="paper"):
        tcore.run_fleet_chunk(state, 2, scaling="paper")


if __name__ == "__main__":
    if "--write-golden" in sys.argv[1:]:
        write_golden()
