"""The dense and broadcast engines of the port against the JAX package:
the flow model's public surface (`compute_flows`, `total_cost`,
`cost_of_flows`, the broadcast fixed point and its gradient), the dense
marginals and `phi_gradients`, Algorithm 1's dense step (`blocked_sets`,
`_taint`, `_max_path_len`) and its runs under both drivers, and the
reference's defaults.

On abilene's φ⁰ and on a repaired iterate (the stored 20-iteration
iterate of `reference_paper.json`, its largest compute node failed and
`refeasibilize`d), flows and marginals agree with the reference's to
rtol 1e-5 (LU and XLA's dot orders differ in the last bits), the
blocked sets and path lengths exactly.  The broadcast gradient equals
`jax.grad` of the reference's `total_cost(method="broadcast")` to rtol
1e-5 and passes `torch.autograd.gradcheck` in float64.  The 10-iteration
runs keep the reference's accepted and rejected steps with costs to
rtol 2e-4 (its stored host-driver runs; `connected_er_dense` also live),
and the fused driver equals the host driver bit for bit.
"""
import inspect
import json
from functools import partial

import jax
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import marginals as jmarg
from repro.core import network as jnetwork
from repro.core import sgp as jsgp
from repro_torch import convert
from repro_torch import core as tcore
from repro_torch.core import network as tnetwork
from repro_torch.core import sgp as tsgp
from test_torch_paper import (PAPER, RUNS, check_run, jax_phi, port_run,
                              stored_iterate)
from test_torch_sgp import jax_net

torch.set_num_threads(1)

RTOL = dict(rtol=1e-5, atol=1e-6)
DENSE_RUNS = [k for k, (_, kind, o) in RUNS.items() if kind == "sgp"]


@pytest.fixture(scope="module")
def golden():
    with open(PAPER) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def cases(golden):
    """(label, port net, port φ, reference net, reference φ): abilene's
    φ⁰, and the stored iterate repaired after its largest compute node
    failed."""
    tnet = tcore.make_scenario(tcore.TABLE_II["abilene"], device="cpu")
    s1 = int(np.argmax(tnet.comp_cost.params.numpy()))
    failed = tcore.fail_node(tnet, s1)
    repaired = tcore.refeasibilize(failed, stored_iterate(golden))
    out = []
    for label, net, phi in (("spt_phi", tnet, tcore.spt_phi(tnet)),
                            ("repaired", failed, repaired)):
        out.append((label, net, phi, jax_net(net), jax_phi(phi)))
    return out


@partial(jax.jit, static_argnames=("method",))
def _reference_eval(net, phi, method):
    fl = jcore.compute_flows(net, phi, method)
    mg = jcore.compute_marginals(net, phi, fl, method)
    perm_d, perm_r = jsgp.blocked_sets(net, phi, mg)
    sup_d, sup_r = jnetwork.support_matrices(net, phi, jsgp.SUPPORT_TOL)
    gd, gr = jmarg.phi_gradients(net, phi, fl, mg)
    return (fl, mg, perm_d, perm_r, jsgp._max_path_len(sup_d),
            jsgp._max_path_len(sup_r), gd, gr,
            jnetwork.cost_of_flows(net, fl))


FLOW_FIELDS = ("t_data", "t_result", "g", "F", "G", "f_data", "f_result")
MARGINAL_FIELDS = ("rho_data", "rho_result", "delta_data", "delta_result",
                   "Dp", "Cp")


@pytest.mark.parametrize("method", ["dense", "broadcast"])
def test_flows_marginals_blocked_match_reference(cases, method):
    for label, tnet, tphi, jnet, jphi in cases:
        (jfl, jmg, jpd, jpr, jhd, jhr, jgd, jgr,
         jT) = _reference_eval(jnet, jphi, method)
        fl = tcore.compute_flows(tnet, tphi, method)
        for f in FLOW_FIELDS:
            np.testing.assert_allclose(getattr(fl, f).numpy(),
                                       np.asarray(getattr(jfl, f)),
                                       err_msg=f"{label} {f}", **RTOL)
        mg = tcore.compute_marginals(tnet, tphi, fl, method)
        for f in MARGINAL_FIELDS:
            np.testing.assert_allclose(getattr(mg, f).numpy(),
                                       np.asarray(getattr(jmg, f)),
                                       err_msg=f"{label} {f}", **RTOL)
        np.testing.assert_allclose(
            float(tcore.total_cost(tnet, tphi, method)), float(jT),
            rtol=1e-6)
        gd, gr = tcore.phi_gradients(tnet, tphi, fl, mg)
        np.testing.assert_allclose(gd.numpy(), np.asarray(jgd), **RTOL)
        np.testing.assert_allclose(gr.numpy(), np.asarray(jgr), **RTOL)
        carry, cost = tcore.flows_carry_and_cost(tnet, tphi, method)
        assert torch.equal(carry.F, fl.F)
        assert float(cost) == float(tcore.cost_of_flows(tnet, fl))
        if method != "dense":
            continue
        perm_d, perm_r = tsgp.blocked_sets(tnet, tphi, mg)
        np.testing.assert_array_equal(perm_d.numpy(), np.asarray(jpd),
                                      label)
        np.testing.assert_array_equal(perm_r.numpy(), np.asarray(jpr),
                                      label)
        sup_d, sup_r = tcore.support_matrices(tnet, tphi, tsgp.SUPPORT_TOL)
        np.testing.assert_array_equal(tsgp._max_path_len(sup_d).numpy(),
                                      np.asarray(jhd), label)
        np.testing.assert_array_equal(tsgp._max_path_len(sup_r).numpy(),
                                      np.asarray(jhr), label)


def test_taint_closes_downstream():
    """A node upstream of an improper edge is tainted; one that is not
    stays clean (a chain 0 -> 1 -> 2 -> 3 with ρ rising at 2 -> 3)."""
    sup = torch.zeros((1, 5, 5), dtype=torch.bool)
    for i, j in ((0, 1), (1, 2), (2, 3)):
        sup[0, i, j] = True
    rho = torch.tensor([[4.0, 3.0, 1.0, 2.0, 0.0]])
    assert tsgp._taint(sup, rho).tolist() == [[True, True, True, False,
                                               False]]


def test_broadcast_gradient_matches_jax_grad(cases):
    """torch.autograd through `_SolveFPBroadcast` against jax.grad
    through the reference's custom VJP, on both iterates."""
    grad = jax.jit(jax.grad(
        lambda phi, net: jcore.total_cost(net, phi, "broadcast")))
    for label, tnet, tphi, jnet, jphi in cases:
        data = tphi.data.clone().requires_grad_(True)
        result = tphi.result.clone().requires_grad_(True)
        T = tcore.total_cost(tnet, tcore.Phi(data, result), "broadcast")
        gd, gr = torch.autograd.grad(T, (data, result))
        want = grad(jphi, jnet)
        np.testing.assert_allclose(gd.numpy(), np.asarray(want.data),
                                   err_msg=label, **RTOL)
        np.testing.assert_allclose(gr.numpy(), np.asarray(want.result),
                                   err_msg=label, **RTOL)


def test_broadcast_gradcheck_float64():
    """gradcheck of the broadcast total cost in float64 on V = 4, S = 2,
    φ restricted to a DAG support (edges i -> j with i < j) so every
    perturbation stays loop-free."""
    V, S = 4, 2
    g = torch.Generator().manual_seed(3)
    adj = torch.ones((V, V), dtype=torch.bool) & ~torch.eye(V, dtype=bool)
    f64 = torch.float64
    net = tcore.CECNetwork(
        adj=adj,
        link_cost=tcore.Cost("queue", 5.0 + torch.rand((V, V), generator=g,
                                                       dtype=f64)),
        comp_cost=tcore.Cost("queue", 4.0 + torch.rand(V, generator=g,
                                                       dtype=f64)),
        dest=torch.tensor([3, 2]), r=torch.rand((S, V), generator=g,
                                                dtype=f64) * 0.3,
        a=torch.tensor([0.5, 1.2], dtype=f64),
        w=torch.ones((S, V), dtype=f64), task_type=torch.tensor([0, 1]))
    up = torch.triu(torch.ones((V, V), dtype=f64), 1)
    mask_d = torch.cat([up, torch.ones((V, 1), dtype=f64)], -1)[None]
    data = torch.rand((S, V, V + 1), generator=g, dtype=f64) * mask_d
    data = (data / data.sum(-1, keepdim=True)).requires_grad_(True)
    result = (torch.rand((S, V, V), generator=g, dtype=f64) * up
              / V).requires_grad_(True)

    def T(d, r):
        return tcore.total_cost(net, tcore.Phi(d * mask_d, r * up),
                                "broadcast")

    assert torch.autograd.gradcheck(T, (data, result))


def test_full_round_broadcast_is_bitwise_early_exit(cases):
    """All V rounds (what a captured CUDA graph runs) equal the early
    exit bit for bit, which stops well before V."""
    for label, tnet, tphi, _, _ in cases:
        adjf = tnet.adj.float()[None]
        for phi_nbr, b in ((tphi.data[..., :-1] * adjf, tnet.r),
                           (tphi.result * adjf, torch.rand(tnet.S, tnet.V))):
            for transpose in (True, False):
                early, k = tnetwork._fixed_point(
                    lambda x: b + torch.einsum(
                        "sij,si->sj" if transpose else "sij,sj->si",
                        phi_nbr, x), b, tnet.V, with_rounds=True,
                    full_rounds=False)
                full = tnetwork._fp_broadcast(phi_nbr, b, transpose,
                                              full_rounds=True)
                assert torch.equal(early, full), label
                assert torch.equal(early, tnetwork._fp_broadcast(
                    phi_nbr, b, transpose)), label
                assert k < tnet.V


@pytest.mark.parametrize("key", DENSE_RUNS)
def test_dense_runs_match_reference(golden, key):
    """10 iterations on the dense and broadcast engines (plain, paper
    scaling, GP): the fused driver equals the host driver bit for bit
    and both keep the reference's steps, costs to rtol 2e-4."""
    name, _, opts = RUNS[key]
    net = tcore.make_scenario(tcore.TABLE_II[name], device="cpu")
    (ph, hh), (pf, hf) = (port_run(net, "sgp", opts, driver=d)
                          for d in ("host", "fused"))
    assert hh["costs"] == hf["costs"] and hh["n_rejected"] == hf["n_rejected"]
    assert torch.equal(ph.data, pf.data) and torch.equal(ph.result,
                                                         pf.result)
    assert isinstance(ph, tcore.Phi)
    check_run(key, hh, golden["runs"][key])


@pytest.mark.parametrize("opts", [
    dict(async_frac=0.3, seed=3), dict(tol=1e-3), dict(kappa=0.5),
    dict(use_blocking=False),
    dict(method="broadcast", scaling="paper", refresh_every=4),
    dict(method="broadcast", variant="gp", beta=0.5),
], ids=["async", "tol", "kappa", "no_blocking", "broadcast_paper",
        "broadcast_gp"])
def test_dense_options_fused_equals_host(opts):
    """Algorithm 1's options on the dense and broadcast engines: the fused
    driver walks the host driver's run bit for bit (Theorem-2 masks from
    one generator seed included)."""
    net = tcore.make_scenario(tcore.TABLE_II["lhc"], device="cpu")
    out = {}
    for driver in ("host", "fused"):
        o = dict(opts)
        if "seed" in o:
            o["rng"] = torch.Generator().manual_seed(o.pop("seed"))
        out[driver] = tcore.run(net, tcore.spt_phi(net), n_iters=12,
                                driver=driver, **o)
    (ph, hh), (pf, hf) = out["host"], out["fused"]
    assert hh["costs"] == hf["costs"] and hh["n_rejected"] == hf["n_rejected"]
    assert torch.equal(ph.data, pf.data) and torch.equal(ph.result,
                                                         pf.result)


def test_live_reference_row(golden):
    """The stored `connected_er_dense` entry re-derived live from the
    reference's host driver (it rejects steps), and the port on it."""
    tnet = tcore.make_scenario(tcore.TABLE_II["connected_er"], device="cpu")
    jnet = jax_net(tnet)
    _, jh = jcore.run(jnet, jcore.spt_phi(jnet), n_iters=10, driver="host")
    want = golden["runs"]["connected_er_dense"]
    assert [float(c) for c in jh["costs"]] == want["costs"]
    assert jh["n_rejected"] == want["n_rejected"] > 0
    _, th = tcore.run(tnet, tcore.spt_phi(tnet), n_iters=10)
    check_run("connected_er_dense live", th, want)


def test_defaults_match_reference():
    """`run`, `init_run_state`, `run_chunk`, `compute_flows`,
    `compute_marginals`, `total_cost` and `flows_carry_and_cost` take the
    reference's defaults (method="dense") wherever both have the
    parameter; a `PhiSparse` is refused by the dense engines."""
    pairs = ((tcore.run, jcore.run),
             (tcore.init_run_state, jsgp.init_run_state),
             (tcore.run_chunk, jsgp.run_chunk),
             (tcore.compute_flows, jcore.compute_flows),
             (tcore.compute_marginals, jcore.compute_marginals),
             (tcore.total_cost, jcore.total_cost),
             (tcore.flows_carry_and_cost, jnetwork.flows_carry_and_cost),
             (tcore.run_spoo, jcore.run_spoo), (tcore.run_lpr,
                                                jcore.run_lpr))
    for port, ref in pairs:
        pp = inspect.signature(port).parameters
        rp = inspect.signature(ref).parameters
        shared = [k for k in pp if k in rp]
        assert [pp[k].default for k in shared] == [
            rp[k].default for k in shared], port.__name__
    assert inspect.signature(tcore.run).parameters["method"].default \
        == "dense"
    net = tcore.make_scenario(tcore.TABLE_II["abilene"], device="cpu")
    with pytest.raises(ValueError, match="sparse"):
        tcore.compute_flows(net, tcore.spt_phi_sparse(net))
    with pytest.raises(ValueError, match="method"):
        tcore.run(net, tcore.spt_phi(net), n_iters=1, method="lu")
    phi0 = tcore.spt_phi(net)
    state = tcore.init_run_state(net, convert.phi_from_numpy(
        phi0.data.numpy(), phi0.result.numpy(), device="cpu"))
    assert state.method == "dense" and state.nbrs is None
