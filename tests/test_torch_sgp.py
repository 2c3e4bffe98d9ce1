"""Algorithm 1 on the port against the JAX package's host driver.

Every small Table II row (five here, the rest and a bucketed
Barabási–Albert spec in test_torch_sgp_rows.py) is held against the
reference's own output on it: the scenario arrays (the same draws
exactly, capacities to float32 rounding), φ⁰ (exactly), and a
10-iteration host-driver run — the cost trajectories agree within rtol
1e-4 with the same number of rejections, and the final φ within atol
1e-4.  The port's chunked driver walks its uninterrupted run bit for
bit.

The reference's outputs are stored in `src/repro_torch/data/
reference_rows.npz`: compiling the reference's jitted driver for each
row's shapes would take most of a minute a row on one CPU core.  One row
(`lhc`, which rejects steps) runs the reference live every time and
checks the stored outputs against it as well as the port.

Run as a script, this file writes the stored outputs:

    PYTHONPATH=src python tests/test_torch_sgp.py [--rows-only]

the small rows, then (unless --rows-only) the golden trajectories that
`chip_smoke.py` holds the card's runs against (`reference_costs.json`:
the reference's host driver, 20 iterations, on `sw_1000` padded and
`ba_10000` bucketed; a few minutes on a CPU).  With `--options-golden
KEY ...` it writes only the named option goldens (OPTION_GOLDENS: the
same runs under `scaling="paper", refresh_every=5`) into that file,
keeping its other keys.
"""
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core.costs import Cost as JCost
from repro.core.sgp import _tol_converged as j_tol_converged
from repro.core.sgp import accept_step as j_accept_step
from repro_torch import core as tcore
from repro_torch.convert import network_to_numpy, phi_sparse_to_numpy
from repro_torch.core.sgp import _tol_converged

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch",
                    "data")
GOLDEN = os.path.join(DATA, "reference_costs.json")
ROWS = os.path.join(DATA, "reference_rows.npz")
N_ITERS = 10
# the rest of the small rows run in test_torch_sgp_rows.py
SMALL_ROWS = ["connected_er", "balanced_tree", "fog", "abilene", "lhc"]
BA_SMALL = tcore.ScenarioSpec("barabasi_albert", 200, 8, 5, 5, "queue",
                              "queue", 30, 30)
# stored row name -> (spec, bucketed)
REFERENCE_ROWS = {
    **{name: (tcore.TABLE_II[name], False) for name in
       SMALL_ROWS + ["geant", "sw_linear", "sw_queue"]},
    "ba_small_bucketed": (BA_SMALL, True)}
NET_FIELDS = ("adj", "dest", "r", "a", "w", "task_type")
PHI_FIELDS = ("data", "local", "result")


def jax_net(net):
    """The reference's CECNetwork holding a port network's arrays."""
    d = network_to_numpy(net)
    return jcore.CECNetwork(
        adj=jnp.asarray(d["adj"]),
        link_cost=JCost(d["link_family"], jnp.asarray(d["link_params"])),
        comp_cost=JCost(d["comp_family"], jnp.asarray(d["comp_params"])),
        dest=jnp.asarray(d["dest"], jnp.int32), r=jnp.asarray(d["r"]),
        a=jnp.asarray(d["a"]), w=jnp.asarray(d["w"]),
        task_type=jnp.asarray(d["task_type"], jnp.int32))


def reference_row(spec, bucketed=False, n_iters=N_ITERS):
    """The JAX package's scenario, φ⁰ and host-driver run, as numpy."""
    jnet = jcore.make_scenario(spec)
    jphi0 = jcore.spt_phi_sparse(jnet)
    jphi, hist = jcore.run(jnet, jphi0, n_iters=n_iters, method="sparse",
                           driver="host", bucketed=bucketed)
    out = {f: np.asarray(getattr(jnet, f)) for f in NET_FIELDS}
    for cost in ("link_cost", "comp_cost"):
        out[f"{cost}_params"] = np.asarray(getattr(jnet, cost).params)
        out[f"{cost}_family"] = np.asarray(getattr(jnet, cost).family)
    for f in PHI_FIELDS:
        out[f"phi0_{f}"] = np.asarray(getattr(jphi0, f))
        out[f"phi_{f}"] = np.asarray(getattr(jphi, f))
    out["costs"] = np.asarray(hist["costs"], np.float64)
    out["n_rejected"] = np.asarray(int(hist["n_rejected"]))
    return out


def stored_row(name):
    with np.load(ROWS) as z:
        return {k.split("__", 1)[1]: z[k] for k in z.files
                if k.startswith(name + "__")}


def check_port_row(ref, spec, bucketed=False, phi_atol=1e-4):
    """Scenario, φ⁰ and the 10-iteration run of the port on the CPU
    against the reference's outputs `ref`.  Returns (phi, hist)."""
    tnet = tcore.make_scenario(spec, device="cpu")
    for f in NET_FIELDS:
        np.testing.assert_array_equal(getattr(tnet, f).numpy(), ref[f],
                                      err_msg=f)
    for cost in ("link_cost", "comp_cost"):
        t = getattr(tnet, cost)
        assert t.family == str(ref[f"{cost}_family"])
        # both packages measure φ⁰ with the dense LU solve up to V = 200;
        # they still sum the flows over the tasks in different orders
        # (XLA's CPU reduce goes left to right, with w·g fused, up to 32
        # tasks and in two halves up to 64), which moves the capacities
        # of fog and geant by up to 2.42e-7 relative
        np.testing.assert_allclose(t.params.numpy(), ref[f"{cost}_params"],
                                   rtol=2.5e-7, err_msg=cost)
    tphi0 = tcore.spt_phi_sparse(tnet)
    for f, got in zip(PHI_FIELDS, phi_sparse_to_numpy(tphi0)):
        np.testing.assert_array_equal(got, ref[f"phi0_{f}"], err_msg=f)
    tphi, th = tcore.run(tnet, tphi0, n_iters=N_ITERS, bucketed=bucketed,
                         method="sparse")
    assert len(th["costs"]) == len(ref["costs"])
    assert th["n_rejected"] == int(ref["n_rejected"])
    np.testing.assert_allclose(th["costs"], ref["costs"], rtol=1e-4)
    costs = np.asarray(th["costs"])
    assert np.isfinite(costs).all() and (np.diff(costs) <= 0).all()
    for f, got in zip(PHI_FIELDS, phi_sparse_to_numpy(tphi)):
        np.testing.assert_allclose(got, ref[f"phi_{f}"], atol=phi_atol,
                                   err_msg=f)
    return tphi, th


@pytest.mark.parametrize("name", SMALL_ROWS)
def test_trajectory_matches_reference(name):
    check_port_row(stored_row(name), tcore.TABLE_II[name])


def test_live_reference_matches_port_and_stored():
    """The reference run now on `lhc` (4 rejected steps in 10) agrees
    with the port, and with its stored outputs to within the compiler's
    last-ulp freedom: exact draws, costs rtol 1e-6, φ atol 1e-6."""
    live = reference_row(tcore.TABLE_II["lhc"])
    check_port_row(live, tcore.TABLE_II["lhc"])
    stored = stored_row("lhc")
    assert sorted(live) == sorted(stored)
    for k, v in live.items():
        if v.dtype.kind in "biuU":
            np.testing.assert_array_equal(v, stored[k], err_msg=k)
        else:
            np.testing.assert_allclose(v, stored[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)


def test_run_chunk_resumes_bitwise():
    """init_run_state + chunks walk exactly the uninterrupted run."""
    net = tcore.make_scenario(tcore.TABLE_II["lhc"], device="cpu")
    phi0 = tcore.spt_phi_sparse(net)
    phi, hist = tcore.run(net, phi0, n_iters=9, method="sparse")
    state = tcore.init_run_state(net, phi0, method="sparse")
    for n in (4, 5):
        tcore.run_chunk(net, state, n)
    assert state.costs == hist["costs"] and state.it == 9
    assert state.n_rejected == hist["n_rejected"]
    for a, b in zip(phi_sparse_to_numpy(phi),
                    phi_sparse_to_numpy(state.phi)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("new,prev,sigma", [
    (1.0, 2.0, 1.0), (2.0, 1.0, 1.0), (1.0, 1.0, 3.0),
    (float("nan"), 1.0, 2.0), (float("inf"), 1.0, 4e11), (5.0, 5.0, 1e12),
    (0.9999999, 1.0, 7.5)])
def test_accept_step_matches_reference(new, prev, sigma):
    assert tcore.accept_step(new, prev, sigma) == j_accept_step(
        new, prev, sigma, "adaptive", "sgp")


@pytest.mark.parametrize("costs,tol", [
    ([5.0, 4.0, 3.0, 2.0, 1.0], 0.1), ([5.0, 4.0, 3.0, 2.0, 1.99], 0.1),
    ([5.0, 4.0, 3.0, 2.0], 1.0), ([3.0] * 6, 0.0)])
def test_tol_converged_matches_reference(costs, tol):
    assert _tol_converged(costs, tol) == j_tol_converged(costs, tol)


def test_cpu_by_request_only():
    """Entry points that create tensors default to the card."""
    assert tcore.resolve_device(None).type == "cuda"
    assert tcore.resolve_device("cpu").type == "cpu"


def write_rows(path=ROWS):
    """The reference's outputs on every stored small row."""
    out = {}
    for name, (spec, bucketed) in REFERENCE_ROWS.items():
        row = reference_row(spec, bucketed)
        out.update({f"{name}__{k}": v for k, v in row.items()})
        print(name, row["costs"].tolist(), int(row["n_rejected"]),
              flush=True)
    np.savez_compressed(path, **out)


def write_golden(path=GOLDEN, n_iters=20):
    """The reference's own trajectories (its scenario, its φ⁰, its host
    driver) on the two card scenarios."""
    out = {}
    for name, bucketed in (("sw_1000", False), ("ba_10000", True)):
        net = jcore.make_scenario(jcore.TABLE_II[name])
        phi0 = jcore.spt_phi_sparse(net)
        _, hist = jcore.run(net, phi0, n_iters=n_iters, method="sparse",
                            driver="host", bucketed=bucketed)
        out[name] = {"bucketed": bucketed, "n_iters": n_iters,
                     "costs": [float(c) for c in hist["costs"]],
                     "n_rejected": int(hist["n_rejected"])}
        print(name, out[name], flush=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


# option goldens: key -> (scenario, bucketed, run options)
PAPER_OPTS = {"scaling": "paper", "refresh_every": 5}
OPTION_GOLDENS = {"sw_1000_paper": ("sw_1000", False, PAPER_OPTS),
                  "ba_10000_paper": ("ba_10000", True, PAPER_OPTS)}


def write_option_golden(keys, path=GOLDEN, n_iters=20):
    """The reference's host-driver trajectories under the options of
    OPTION_GOLDENS[key], added to `path` beside its other keys."""
    with open(path) as f:
        out = json.load(f)
    for key in keys:
        name, bucketed, opts = OPTION_GOLDENS[key]
        net = jcore.make_scenario(jcore.TABLE_II[name])
        phi0 = jcore.spt_phi_sparse(net)
        _, hist = jcore.run(net, phi0, n_iters=n_iters, method="sparse",
                            driver="host", bucketed=bucketed, **opts)
        out[key] = {"scenario": name, "bucketed": bucketed,
                    "n_iters": n_iters, "options": opts,
                    "costs": [float(c) for c in hist["costs"]],
                    "n_rejected": int(hist["n_rejected"])}
        print(key, out[key], flush=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    args = sys.argv[1:]
    if "--options-golden" in args:
        write_option_golden(args[args.index("--options-golden") + 1:])
    else:
        write_rows()
        if "--rows-only" not in args:
            write_golden()
