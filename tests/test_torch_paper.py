"""The paper's evaluation on the port against the JAX package: node
failure (`fail_node`, `refeasibilize`), the optimality certificates
(`theorem1_residual`, `is_loop_free`, `marginals_vs_autodiff`,
`flow_domain_optimum`), the baselines (`run_spoo`, `run_lcor`,
`run_lpr`) and `convert.phi_from_numpy`.

The reference's long runs are stored in `src/repro_torch/data/
reference_paper.json` (the JAX package's host driver on the CPU): the
10-iteration runs the tests hold the port to, a 20-iteration abilene
iterate with the reference's certificates on it, the flow-domain
optimum of a hand-made net, and the 200-300
iteration runs of `chip_smoke.py`'s `paper` phase (Fig. 4, 5b, 5c, 5d
and abilene's optimality), which that phase recomputes on the card.
`tests/test_torch_dense.py` runs one stored entry live against the
reference (`connected_er_dense`).  Written by

    PYTHONPATH=src python tests/test_torch_paper.py --write-golden

(a few minutes on a CPU; `--l-witness` prints how far a one-ulp change
of the capacities moves Fig. 5d's L_data / L_result in the reference).

Tolerances: fail_node, refeasibilize and LPR's totals are exact (the
same float32 and numpy operations on the same inputs); the 10-iteration
runs keep the reference's accepted and rejected steps with costs to
rtol 2e-4; the certificates agree to float32 rounding of their sums
(theorem1 and lemma1 to 1e-5, the autodiff check to 1e-6 abs); SLSQP
follows its callbacks' float32 sums, held to rtol 1e-5.
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
from repro.core import baselines as jbase
from repro.core import optimality as jopt
from repro_torch import convert
from repro_torch import core as tcore
from test_torch_sgp import DATA, jax_net

# the figures' derivations that the card's `paper` phase uses
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import fig4_summary, iters_to  # noqa: E402

torch.set_num_threads(1)

PAPER = os.path.join(DATA, "reference_paper.json")
FIG4 = ["connected_er", "balanced_tree", "fog", "abilene", "lhc", "geant",
        "sw_linear", "sw_queue"]
# the 10-iteration runs the CPU tests hold the port to: (scenario, kind,
# run options)
RUNS = {
    "connected_er_dense": ("connected_er", "sgp", {"method": "dense"}),
    "connected_er_broadcast": ("connected_er", "sgp",
                               {"method": "broadcast"}),
    "abilene_dense": ("abilene", "sgp", {"method": "dense"}),
    "abilene_dense_paper": ("abilene", "sgp",
                            {"method": "dense", "scaling": "paper",
                             "refresh_every": 5}),
    "connected_er_dense_gp": ("connected_er", "sgp",
                              {"method": "dense", "variant": "gp",
                               "beta": 0.3}),
    "abilene_spoo": ("abilene", "spoo", {}),
    "abilene_lcor": ("abilene", "lcor", {}),
    "connected_er_spoo": ("connected_er", "spoo", {}),
    "connected_er_lcor": ("connected_er", "lcor", {}),
}
RUN_ITERS = 10


@pytest.fixture(scope="module")
def golden():
    with open(PAPER) as f:
        return json.load(f)


_NETS = {}


def _nets(name):
    """The port's scenario on the CPU and the reference's CECNetwork
    holding the same arrays."""
    if name not in _NETS:
        tnet = tcore.make_scenario(tcore.TABLE_II[name], device="cpu")
        _NETS[name] = (tnet, jax_net(tnet))
    return _NETS[name]


def jax_phi(phi):
    return jcore.Phi(jnp.asarray(phi.data.numpy()),
                     jnp.asarray(phi.result.numpy()))


def stored_iterate(golden):
    it = golden["iterate"]
    return convert.phi_from_numpy(it["data"], it["result"], device="cpu")


def port_run(net, kind, opts, n_iters=RUN_ITERS, driver=None):
    """One of RUNS on the port: SGP from φ⁰ or a baseline."""
    if kind == "sgp":
        return tcore.run(net, tcore.spt_phi(net), n_iters=n_iters,
                         driver=driver, **opts)
    fn = {"spoo": tcore.run_spoo, "lcor": tcore.run_lcor}[kind]
    return fn(net, n_iters=n_iters, driver=driver, **opts)


def check_run(label, hist, want, rtol=2e-4):
    """The same accepted and rejected steps, costs to `rtol`."""
    assert len(hist["costs"]) == len(want["costs"]), label
    assert hist["n_rejected"] == want["n_rejected"], label
    np.testing.assert_allclose(hist["costs"], want["costs"], rtol=rtol,
                               err_msg=label)


# ---------------------------------------------------------------- tests
def test_core_exports_reference_names():
    for name in ("run_all", "run_spoo", "run_lcor", "run_lpr",
                 "theorem1_residual", "marginals_vs_autodiff",
                 "flow_domain_optimum", "fail_node", "hub_node",
                 "churn_hub", "refeasibilize", "is_loop_free",
                 "support_matrices", "total_cost", "cost_of_flows"):
        assert callable(getattr(tcore, name)), name
        assert any(callable(getattr(m, name, None)) for m in (
            jcore, jcore.network, jcore.scenarios, jbase, jopt)), name


def test_phi_from_numpy(golden):
    phi = stored_iterate(golden)
    assert isinstance(phi, tcore.Phi) and phi.data.dtype == torch.float32
    np.testing.assert_array_equal(phi.data.numpy(),
                                  np.asarray(golden["iterate"]["data"],
                                             np.float32))
    assert phi.result.shape == (10, 11, 11)


def test_fail_node_and_refeasibilize_exact(golden):
    """fail_node of the largest compute node (Fig. 5b's failure) and of
    the hub, then refeasibilize of the stored iterate: equal to the
    reference's outputs exactly; the failed node keeps its (empty) row."""
    tnet, jnet = _nets("abilene")
    phi = stored_iterate(golden)
    s1 = int(np.argmax(tnet.comp_cost.params.numpy()))
    assert tcore.hub_node(tnet) == jcore.hub_node(jnet)
    assert tcore.churn_hub(tnet) == jcore.churn_hub(jnet)
    for node in (s1, tcore.hub_node(tnet)):
        tn2, jn2 = tcore.fail_node(tnet, node), jcore.fail_node(jnet, node)
        for f in ("adj", "r", "a", "w", "dest"):
            np.testing.assert_array_equal(getattr(tn2, f).numpy(),
                                          np.asarray(getattr(jn2, f)), f)
        np.testing.assert_array_equal(tn2.comp_cost.params.numpy(),
                                      np.asarray(jn2.comp_cost.params))
        assert not tn2.adj[node].any() and not tn2.adj[:, node].any()
        got = tcore.refeasibilize(tn2, phi)
        want = jcore.refeasibilize(jn2, jax_phi(phi))
        np.testing.assert_array_equal(got.data.numpy(),
                                      np.asarray(want.data))
        np.testing.assert_array_equal(got.result.numpy(),
                                      np.asarray(want.result))
        assert bool(tcore.is_loop_free(tn2, got))
    rebuild = torch.zeros(tnet.S, dtype=torch.bool)
    rebuild[2] = True
    tn2 = tcore.fail_node(tnet, s1)
    got = tcore.refeasibilize(tn2, phi, rebuild_tasks=rebuild)
    want = jcore.refeasibilize(jcore.fail_node(jnet, s1), jax_phi(phi),
                               rebuild_tasks=jnp.asarray(rebuild.numpy()))
    np.testing.assert_array_equal(got.result.numpy(), np.asarray(want.result))


def test_failed_node_on_every_engine(golden):
    """After `fail_node` (Fig. 5b's: the largest compute node) the
    failed node keeps its row with no edge: the neighbour lists give it
    an all-padding row, and the sparse engine (K1's plain version), the
    broadcast and the dense engine agree on the repaired iterate's flows
    and cost; 10 iterations from it walk the same accepted steps on the
    sparse and dense engines.  (After the hub fails, abilene's flows
    pass SAT·capacity and the reference's own dense and sparse runs part
    at the first step, by rtol 2e-5.)"""
    tnet, _ = _nets("abilene")
    node = int(np.argmax(tnet.comp_cost.params.numpy()))
    net = tcore.fail_node(tnet, node)
    nbrs = tcore.build_neighbors(net.adj)
    assert not nbrs.out_mask[node].any() and not nbrs.in_mask[node].any()
    phi = tcore.refeasibilize(net, stored_iterate(golden))
    flows = {m: tcore.compute_flows(net, phi, m)
             for m in ("dense", "broadcast", "sparse")}
    for m in ("broadcast", "sparse"):
        for f in ("t_data", "t_result", "F", "G"):
            np.testing.assert_allclose(getattr(flows[m], f).numpy(),
                                       getattr(flows["dense"], f).numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=m + f)
    _, dense = tcore.run(net, phi, n_iters=10)
    _, sparse = tcore.run(net, phi, n_iters=10, method="sparse")
    check_run("failed abilene, sparse vs dense", sparse, dense, rtol=1e-5)


def test_certificates_match_reference(golden):
    """theorem1_residual, is_loop_free, marginals_vs_autodiff and
    total_cost on the stored iterate (the reference's 20-iteration
    dense run on abilene), against the reference's values on it."""
    tnet, _ = _nets("abilene")
    want = golden["iterate"]
    phi = stored_iterate(golden)
    got = tcore.theorem1_residual(tnet, phi)
    assert got["loop_free"] is want["loop_free"] is True
    for k in ("theorem1", "lemma1"):
        assert abs(got[k] - want[k]) <= 1e-5, k
    assert abs(tcore.marginals_vs_autodiff(tnet, phi)
               - want["marginals_vs_autodiff"]) <= 1e-6
    np.testing.assert_allclose(float(tcore.total_cost(tnet, phi)),
                               want["total_cost"], rtol=1e-6)
    sup_d, sup_r = tcore.support_matrices(tnet, phi)
    assert sup_d.shape == sup_r.shape == (10, 11, 11)
    # a loop closes: the support is no longer a DAG
    res = phi.result.clone()
    i, j = (int(x) for x in torch.nonzero(tnet.adj)[0])
    s = int(torch.nonzero(tnet.dest != i)[0])
    res[s, i, j] = res[s, j, i] = 0.5
    assert not bool(tcore.is_loop_free(tnet, tcore.Phi(phi.data, res)))


def _small_net():
    """A hand-made net for the flow-domain program: V = 6, S = 2, queue
    costs, one heavy source."""
    V = 6
    adj = np.zeros((V, V), bool)
    for u, v in [(0, 1), (1, 2), (2, 5), (0, 3), (3, 4), (4, 5), (1, 4),
                 (3, 1)]:
        adj[u, v] = adj[v, u] = True
    link = np.where(adj, 4.0, 1.0) + np.arange(V * V).reshape(V, V) % 3
    r = np.zeros((2, V), np.float32)
    r[0, [0, 3]] = [1.2, 0.4]
    r[1, [2, 4]] = [0.6, 0.9]
    fields = dict(adj=adj, link_params=link, comp_params=[3, 5, 2, 4, 6, 3],
                  dest=[5, 0], r=r, a=[0.5, 1.5],
                  w=np.full((2, V), 1.5), task_type=[0, 1])
    return convert.network_from_numpy(**fields, link_family="queue",
                                      comp_family="queue", device="cpu")


def test_flow_domain_optimum_small(golden):
    """SLSQP on a hand-made V = 6, S = 2 net: the port's optimum equals
    the reference's (stored) to rtol 1e-5, lies below φ⁰'s cost, and the
    port's dense Algorithm 1 reaches it within 1 %."""
    tnet = _small_net()
    got = tcore.flow_domain_optimum(tnet, maxiter=200)
    np.testing.assert_allclose(
        got, golden["small_net"]["flow_domain_optimum"], rtol=1e-5)
    assert got < float(tcore.total_cost(tnet, tcore.spt_phi(tnet)))
    _, hist = tcore.run(tnet, tcore.spt_phi(tnet), n_iters=60)
    assert hist["final_cost"] <= 1.01 * got


@pytest.mark.parametrize("name", ["abilene", "connected_er"])
def test_run_lpr_exact(name):
    """LPR's LP branch (HiGHS) and its greedy branch (max_lp_vars=0):
    the same totals, flows and path lengths as the reference's."""
    tnet, jnet = _nets(name)
    for kw in ({}, {"max_lp_vars": 0}):
        got, want = tcore.run_lpr(tnet, **kw), jbase.run_lpr(jnet, **kw)
        assert got["final_cost"] == want["final_cost"], kw
        np.testing.assert_array_equal(got["F"], want["F"])
        np.testing.assert_array_equal(got["G"], want["G"])
        assert (got["L_data"], got["L_result"]) == (want["L_data"],
                                                    want["L_result"])


@pytest.mark.parametrize("key", ["abilene_spoo", "abilene_lcor",
                                 "connected_er_spoo", "connected_er_lcor"])
def test_baseline_runs_match_reference(golden, key):
    """SPOO and LCOR, 10 iterations on the dense engine, against the
    reference's stored runs."""
    name, kind, opts = RUNS[key]
    tnet, _ = _nets(name)
    phi, hist = port_run(tnet, kind, opts)
    check_run(key, hist, golden["runs"][key])
    assert isinstance(phi, tcore.Phi)


def test_golden_holds_the_paper_phase(golden):
    """Every section the card's `paper` phase reads, with the derived
    figures as the fig scripts derive them."""
    f4 = golden["fig4"]
    assert f4["scenarios"] == FIG4 and set(f4["totals"]) == set(FIG4)
    wins, ratio = fig4_summary(f4["totals"])
    assert (wins, ratio) == (f4["sgp_wins"],
                             f4["mean_ratio_vs_best_baseline"])
    for sec in ("fig5b", "fig5c", "fig5d", "optimality"):
        assert golden[sec]["scenario"] in tcore.TABLE_II
    b = golden["fig5b"]
    for v in ("sgp", "gp"):
        curve = b["curves"][v]
        assert b["recover_iters"][v] == iters_to(
            curve[b["fail_at"]:], b["curves"]["sgp"][-1] * 1.01)
    opt = golden["optimality"]
    assert opt["theorem1"] < 0.05 and opt["loop_free"]
    assert opt["final_cost"] <= 1.01 * opt["flow_domain_optimum"]


# ------------------------------------------------------- golden writer
def ref_run(jnet, kind, opts, n_iters):
    """The reference's host-driver run of one kind."""
    if kind == "sgp":
        return jcore.run(jnet, jcore.spt_phi(jnet), n_iters=n_iters,
                         driver="host", **opts)
    fn = {"spoo": jbase.run_spoo, "lcor": jbase.run_lcor}[kind]
    return fn(jnet, n_iters=n_iters, driver="host", **opts)


def ref_run_all(jnet, n_iters):
    """`baselines.run_all` with the host driver in each SGP run."""
    out = {}
    for label, kind, opts in (("SGP", "sgp", {}), ("SPOO", "spoo", {}),
                              ("LCOR", "lcor", {})):
        out[label] = ref_run(jnet, kind, opts, n_iters)[1]["final_cost"]
    out["LPR"] = jbase.run_lpr(jnet)["final_cost"]
    return out


def hist_json(hist):
    return {"costs": [float(c) for c in hist["costs"]],
            "n_rejected": int(hist["n_rejected"])}


def write_golden():
    out = {"source": "the JAX package (repro.core), driver='host', on the "
           "CPU: PYTHONPATH=src python tests/test_torch_paper.py "
           "--write-golden"}
    out["small_net"] = {"flow_domain_optimum": jopt.flow_domain_optimum(
        jax_net(_small_net()), maxiter=200)}
    out["runs"] = {}
    for key, (name, kind, opts) in RUNS.items():
        jnet = jcore.make_scenario(jcore.TABLE_II[name])
        out["runs"][key] = {"scenario": name, "kind": kind,
                            "options": opts, "n_iters": RUN_ITERS,
                            **hist_json(ref_run(jnet, kind, opts,
                                                RUN_ITERS)[1])}
        print(key, out["runs"][key], flush=True)

    jnet = jcore.make_scenario(jcore.TABLE_II["abilene"])
    phi, _ = jcore.run(jnet, jcore.spt_phi(jnet), n_iters=20, driver="host")
    out["iterate"] = {
        "scenario": "abilene", "n_iters": 20,
        "data": np.asarray(phi.data).tolist(),
        "result": np.asarray(phi.result).tolist(),
        **jopt.theorem1_residual(jnet, phi),
        "marginals_vs_autodiff": jopt.marginals_vs_autodiff(jnet, phi),
        "total_cost": float(jcore.total_cost(jnet, phi))}

    n4 = 250
    totals = {}
    for name in FIG4:
        totals[name] = ref_run_all(jcore.make_scenario(jcore.TABLE_II[name]),
                                   n4)
        print("fig4", name, totals[name], flush=True)
    wins, ratio = fig4_summary(totals)
    out["fig4"] = {"scenarios": FIG4, "n_iters": n4, "totals": totals,
                   "sgp_wins": wins, "mean_ratio_vs_best_baseline": ratio}

    scales = [0.6, 1.0, 1.4, 1.8]
    rows = {}
    for s in scales:
        rows[str(s)] = ref_run_all(jcore.make_scenario(
            jcore.TABLE_II["connected_er"], rate_scale=s), 200)
        print("fig5c", s, rows[str(s)], flush=True)
    out["fig5c"] = {"scenario": "connected_er", "n_iters": 200,
                    "scales": scales, "totals": rows,
                    "advantage": {k: min(v for a, v in o.items()
                                         if a != "SGP") / max(o["SGP"], 1e-9)
                                  for k, o in rows.items()}}

    jnet = jcore.make_scenario(jcore.TABLE_II["connected_er"])
    s1 = int(np.argmax(np.asarray(jnet.comp_cost.params)))
    curves, split = {}, {}
    for variant, kw in (("sgp", {}), ("gp", {"variant": "gp",
                                             "beta": 0.3})):
        phi, h = jcore.run(jnet, jcore.spt_phi(jnet), n_iters=100,
                           driver="host", **kw)
        net2 = jcore.fail_node(jnet, s1)
        phi2 = jcore.refeasibilize(net2, phi)
        _, h2 = jcore.run(net2, phi2, n_iters=120, driver="host", **kw)
        curves[variant] = [float(c) for c in h["costs"] + h2["costs"]]
        split[variant] = len(h["costs"])
    out["fig5b"] = {
        "scenario": "connected_er", "fail_at": 100, "n_iters_after": 120,
        "gp_beta": 0.3, "failed_node": s1, "curves": curves,
        "split": split,
        # sliced at fail_at, as fig5b_convergence.py does
        "recover_iters": {v: iters_to(curves[v][100:],
                                      curves["sgp"][-1] * 1.01)
                          for v in curves}}
    print("fig5b", out["fig5b"]["recover_iters"], flush=True)

    ams = [0.2, 0.5, 1.0, 2.0, 4.0]
    rows = {}
    for am in ams:
        jnet = jcore.make_scenario(jcore.TABLE_II["connected_er"])
        jnet = dataclasses.replace(jnet, a=jnp.full_like(jnet.a, am))
        jnet = jcore.enforce_feasibility(jnet)
        phi, h = jcore.run(jnet, jcore.spt_phi(jnet), n_iters=200,
                           driver="host")
        fl = jcore.compute_flows(jnet, phi)
        computed = float(jnp.sum(fl.g))
        delivered = float(jnp.sum(jnet.a[:, None] * fl.g))
        rows[str(am)] = {
            "L_data": float(jnp.sum(fl.f_data)) / max(computed, 1e-9),
            "L_result": float(jnp.sum(fl.f_result)) / max(delivered, 1e-9),
            "final_cost": float(h["final_cost"])}
        print("fig5d", am, rows[str(am)], flush=True)
    out["fig5d"] = {"scenario": "connected_er", "n_iters": 200, "ams": ams,
                    "rows": rows}

    jnet = jcore.make_scenario(jcore.TABLE_II["abilene"])
    phi, h = jcore.run(jnet, jcore.spt_phi(jnet), n_iters=300, driver="host")
    out["optimality"] = {
        "scenario": "abilene", "n_iters": 300,
        "final_cost": float(h["final_cost"]),
        **jopt.theorem1_residual(jnet, phi),
        "marginals_vs_autodiff": jopt.marginals_vs_autodiff(jnet, phi),
        "flow_domain_optimum": jopt.flow_domain_optimum(jnet)}
    print("optimality", out["optimality"], flush=True)
    with open(PAPER, "w") as f:
        json.dump(out, f)
        f.write("\n")


def l_witness(am=0.5):
    """How far Fig. 5d's L_data / L_result move under a one-ulp change
    of the link capacities, in the reference itself (200 iterations of
    its host driver at a_m = `am`, capacities nudged up by one float32
    ulp) and in the port on the CPU (unchanged inputs), against the
    stored golden: prints each row's values and relative distances."""
    want = json.load(open(PAPER))["fig5d"]["rows"][str(am)]

    def distances(net, phi, cost):
        fl = jcore.compute_flows(net, phi)
        computed = float(jnp.sum(fl.g))
        delivered = float(jnp.sum(net.a[:, None] * fl.g))
        return {"L_data": float(jnp.sum(fl.f_data)) / max(computed, 1e-9),
                "L_result": float(jnp.sum(fl.f_result))
                / max(delivered, 1e-9), "final_cost": float(cost)}

    jnet = jcore.make_scenario(jcore.TABLE_II["connected_er"])
    jnet = dataclasses.replace(jnet, a=jnp.full_like(jnet.a, am))
    jnet = jcore.enforce_feasibility(jnet)
    cap = np.asarray(jnet.link_cost.params)
    nudged = dataclasses.replace(jnet, link_cost=jcore.Cost(
        "queue", jnp.asarray(np.nextafter(cap, np.float32(np.inf)))))
    phi, h = jcore.run(nudged, jcore.spt_phi(nudged), n_iters=200,
                       driver="host")
    rows = {"reference, one ulp": distances(nudged, phi, h["final_cost"])}
    tnet = tcore.make_scenario(tcore.TABLE_II["connected_er"], device="cpu")
    tnet = dataclasses.replace(tnet, a=torch.full_like(tnet.a, am))
    tnet = tcore.enforce_feasibility(tnet)
    tphi, th = tcore.run(tnet, tcore.spt_phi(tnet), n_iters=200)
    rows["port, CPU"] = distances(jax_net(tnet), jax_phi(tphi),
                                  th["final_cost"])
    for label, got in rows.items():
        print(label, got, {k: abs(got[k] - want[k]) / abs(want[k])
                           for k in want})


if __name__ == "__main__":
    if "--write-golden" in sys.argv[1:]:
        write_golden()
    if "--l-witness" in sys.argv[1:]:
        l_witness()
