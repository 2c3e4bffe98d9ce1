"""Optimality certificates (Lemma 1, Theorem 1) and an independent
convex flow-domain solver, as in the JAX package's `core/optimality.py`.

T is not convex in φ but is jointly convex in the flows (f⁻, f⁺, g)
over a polytope.  `flow_domain_optimum` solves that convex program
directly (scipy SLSQP on the host, the objective and its gradient from
the port's cost families on the net's device): an independent global
optimum that Algorithm 1 must reach (Theorem 1 ⇒ Theorem 2).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .costs import FAMILIES
from .marginals import BIG, compute_marginals
from .network import (CECNetwork, Phi, as_dense_phi, compute_flows,
                      cost_of_flows, is_loop_free, spt_phi)


def theorem1_residual(net: CECNetwork, phi, tol: float = 1e-6) -> Dict:
    """Worst violation of the Theorem-1 conditions: on every (node,
    task) row, each active coordinate (φ > tol) must reach the row's
    minimum δ.  Returns the worst gap δ_active − δ_min ("theorem1"), the
    same gap scaled by traffic (the Lemma-1 residual, "lemma1") and
    whether φ is loop-free.  A `PhiSparse` is converted at this boundary
    (the check runs on the dense engine)."""
    phi = as_dense_phi(phi, net)
    fl = compute_flows(net, phi)
    mg = compute_marginals(net, phi, fl)
    is_dest = (torch.arange(net.V, device=net.device)[None]
               == net.dest[:, None])
    every = torch.ones((net.S, net.V), dtype=torch.bool, device=net.device)

    def gaps(phi_mat, delta, row_valid):
        active = phi_mat > tol
        dmin = torch.where(delta < BIG / 2, delta, BIG).amin(-1, keepdim=True)
        gap = torch.where(active, delta - dmin, 0.0)
        gap = torch.where(row_valid[..., None], gap, 0.0)
        return gap.max()

    g_d = gaps(phi.data, mg.delta_data, every)
    g_r = gaps(phi.result, mg.delta_result, ~is_dest)
    l_d = gaps(phi.data, fl.t_data[..., None] * mg.delta_data, every)
    l_r = gaps(phi.result, fl.t_result[..., None] * mg.delta_result,
               ~is_dest)
    return {"theorem1": float(torch.maximum(g_d, g_r)),
            "lemma1": float(torch.maximum(l_d, l_r)),
            "loop_free": bool(is_loop_free(net, phi, tol=tol))}


def marginals_vs_autodiff(net: CECNetwork, phi) -> float:
    """The closed-form Lemma-1 gradient t ⊙ δ (Eq. 9-12) against
    torch.autograd through the dense flow solve: the max abs difference
    on the edges and the local column.  The perturbation is not held
    feasible: both sides are the same unconstrained partial derivative."""
    phi = as_dense_phi(phi, net)
    data = phi.data.detach().clone().requires_grad_(True)
    result = phi.result.detach().clone().requires_grad_(True)
    T = cost_of_flows(net, compute_flows(net, Phi(data, result)))
    g_data, g_result = torch.autograd.grad(T, (data, result))
    with torch.no_grad():
        fl = compute_flows(net, phi)
        mg = compute_marginals(net, phi, fl)
        gd = fl.t_data[..., None] * mg.delta_data
        gr = fl.t_result[..., None] * mg.delta_result
        S, V = net.S, net.V
        mask_d = torch.cat([net.adj[None].expand(S, V, V),
                            torch.ones((S, V, 1), dtype=torch.bool,
                                       device=net.device)], dim=-1)
        err_d = torch.where(mask_d, g_data - gd, 0.0).abs().max()
        err_r = torch.where(net.adj[None], g_result - gr, 0.0).abs().max()
        return float(torch.maximum(err_d, err_r))


def flow_domain_optimum(net: CECNetwork, maxiter: int = 800) -> float:
    """The global optimum of the convex flow-domain program (24), by
    scipy SLSQP on the host.

    Variables per task s: f⁻[e], f⁺[e] on the directed edges, g[i].
    Conservation:  r_i + Σ_in f⁻ = Σ_out f⁻ + g_i          (data)
                   a_s g_i + Σ_in f⁺ = Σ_out f⁺            (result, i≠d)
    Meant for small instances (V ≤ ~12, S ≤ ~4), as the reference's.
    The objective and gradient evaluate the cost families in float32 on
    the net's device, as the reference evaluates them in float32."""
    from scipy.optimize import LinearConstraint, minimize

    dev = net.device
    adj = net.adj.cpu().numpy()
    V, S = net.V, net.S
    edges = [(u, v) for u in range(V) for v in range(V) if adj[u, v]]
    E = len(edges)
    nvar = S * (2 * E + V)

    def unpack(z):
        z = z.reshape(S, 2 * E + V)
        return z[:, :E], z[:, E:2 * E], z[:, 2 * E:]

    eu, ev = (np.asarray(x, dtype=np.int64) for x in zip(*edges))
    lp = net.link_cost.params[torch.as_tensor(eu, device=dev),
                              torch.as_tensor(ev, device=dev)]
    cpar = net.comp_cost.params
    r = net.r.cpu().numpy()
    a = net.a.cpu().numpy()
    w = net.w.cpu().numpy()
    dests = net.dest.cpu().numpy()
    fam_l = FAMILIES[net.link_cost.family]
    fam_c = FAMILIES[net.comp_cost.family]

    def f32(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)

    def flows(z):
        fd, fr, g = unpack(z)
        return (fd + fr).sum(axis=0), (w * g).sum(axis=0)

    def total(x):
        # float32, left to right: the order of the reference's sums (XLA
        # sums up to 32 terms so on the CPU), whose float32 rounding the
        # SLSQP path follows
        return np.cumsum(x.cpu().numpy(), dtype=np.float32)[-1]

    def obj(z):
        F, G = flows(z)
        return float(total(fam_l.value(f32(F), lp))
                     + total(fam_c.value(f32(G), cpar)))

    def grad(z):
        F, G = flows(z)
        dF = fam_l.d1(f32(F), lp).cpu().numpy()
        dG = fam_c.d1(f32(G), cpar).cpu().numpy()
        out = np.zeros((S, 2 * E + V))
        out[:, :E] = dF[None]
        out[:, E:2 * E] = dF[None]
        out[:, 2 * E:] = w * dG[None]
        return out.ravel()

    # conservation constraints
    rows, rhs = [], []
    for s in range(S):
        base = s * (2 * E + V)
        for i in range(V):
            row = np.zeros(nvar)
            for q, (u, v) in enumerate(edges):
                if v == i:
                    row[base + q] += 1.0
                if u == i:
                    row[base + q] -= 1.0
            row[base + 2 * E + i] = -1.0
            rows.append(row)
            rhs.append(-r[s, i])
        for i in range(V):
            if i == dests[s]:
                continue
            row = np.zeros(nvar)
            for q, (u, v) in enumerate(edges):
                if v == i:
                    row[base + E + q] += 1.0
                if u == i:
                    row[base + E + q] -= 1.0
            row[base + 2 * E + i] = a[s]
            rows.append(row)
            rhs.append(0.0)
    A = np.asarray(rows)
    b = np.asarray(rhs)

    # feasible start: the flows of φ⁰ (local compute, results on the
    # shortest-path tree)
    fl0 = compute_flows(net, spt_phi(net))
    z0 = np.zeros((S, 2 * E + V))
    z0[:, :E] = fl0.f_data[:, eu, ev].cpu().numpy()
    z0[:, E:2 * E] = fl0.f_result[:, eu, ev].cpu().numpy()
    z0[:, 2 * E:] = fl0.g.cpu().numpy()

    res = minimize(obj, z0.ravel(), jac=grad, method="SLSQP",
                   bounds=[(0, None)] * nvar,
                   constraints=[LinearConstraint(A, b, b)],
                   options={"maxiter": maxiter, "ftol": 1e-12})
    return float(res.fun)
