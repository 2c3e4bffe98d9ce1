"""Baseline algorithms of the paper's §V: GP, SPOO, LCOR, LPR.

GP is `sgp.run(..., variant="gp")`.  SPOO and LCOR are restricted SGP
runs (the paper defines them as optimizing a subset of the variables
with the rest fixed), on the engine `method=` names (the reference's
default, "dense").  LPR is the linear-program-rounded joint method of
Liu et al. [8]: single-path (non-partial) offloading over shortest paths
with linearized costs and a 0.7 capacity saturate factor, solved on the
host (scipy HiGHS, or a greedy assignment above `max_lp_vars`) and
evaluated under the true convex cost on the net's device.

The shortest paths are one Floyd-Warshall on the host, O(V³): seconds
at V = 1000, out of reach at V = 10⁴, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import sgp
from .network import CECNetwork, spt_phi


# ------------------------------------------------------------ shortest paths
def all_pairs_next_hop(adj: np.ndarray, weight: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Floyd-Warshall: (dist[i, j], next_hop[i, j]) under edge weights."""
    V = adj.shape[0]
    dist = np.where(adj, weight, 1e30).astype(np.float64)
    np.fill_diagonal(dist, 0.0)
    nxt = np.where(adj, np.arange(V)[None, :], -1)
    for k in range(V):
        alt = dist[:, k:k + 1] + dist[k:k + 1, :]
        better = alt < dist
        dist = np.where(better, alt, dist)
        nxt = np.where(better, nxt[:, k:k + 1], nxt)
    return dist, nxt


def _zero_flow_weights(net: CECNetwork) -> np.ndarray:
    """Link weights: the marginal cost at zero flow (≥ 1e-12), 1e30 off
    the edges."""
    V = net.V
    w = net.link_cost.d1(torch.zeros((V, V), device=net.device))
    return np.where(net.adj.cpu().numpy(), np.maximum(w.cpu().numpy(),
                                                      1e-12), 1e30)


def _path(nxt: np.ndarray, i: int, j: int):
    """Edge list of the shortest path i -> j (empty if i == j; None if
    there is none)."""
    path = []
    u = i
    for _ in range(nxt.shape[0] + 1):
        if u == j:
            return path
        v = nxt[u, j]
        if v < 0:
            return None
        path.append((u, int(v)))
        u = int(v)
    return None  # cycle guard


# -------------------------------------------------------------------- SPOO
def run_spoo(net: CECNetwork, n_iters: int = 200, **kw):
    """Shortest Path Optimal Offloading: routing pinned to the
    shortest-path tree toward each destination; only the offloading
    fractions are optimized.  `kw` goes to `sgp.run`."""
    adj = net.adj.cpu().numpy()
    V, S = net.V, net.S
    _, nxt = all_pairs_next_hop(adj, _zero_flow_weights(net))
    dests = net.dest.cpu().numpy()
    allowed_d = np.zeros((S, V, V + 1), dtype=bool)
    allowed_d[..., -1] = True
    allowed_r = np.zeros((S, V, V), dtype=bool)
    for s in range(S):
        d = int(dests[s])
        for i in range(V):
            if i == d:
                continue
            h = nxt[i, d]
            if h >= 0:
                allowed_d[s, i, h] = True
                allowed_r[s, i, h] = True
    dev = net.device
    return sgp.run(net, spt_phi(net), n_iters=n_iters,
                   allowed_data=torch.as_tensor(allowed_d, device=dev),
                   allowed_result=torch.as_tensor(allowed_r, device=dev),
                   use_blocking=False, **kw)


# -------------------------------------------------------------------- LCOR
def run_lcor(net: CECNetwork, n_iters: int = 200, **kw):
    """Local Computation Optimal Routing: φ⁻_i0 ≡ 1; the result routing
    optimized by scaled gradient projection [25].  `kw` goes to
    `sgp.run`."""
    V, S = net.V, net.S
    allowed_d = np.zeros((S, V, V + 1), dtype=bool)
    allowed_d[..., -1] = True
    return sgp.run(net, spt_phi(net), n_iters=n_iters,
                   allowed_data=torch.as_tensor(allowed_d,
                                                device=net.device), **kw)


# --------------------------------------------------------------------- LPR
def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def run_lpr(net: CECNetwork, saturate: float = 0.7,
            max_lp_vars: int = 60000) -> Dict:
    """Linear Program Rounded [8], adapted per the paper's §V:

    * linearized costs: the marginal cost at zero flow;
    * no partial offloading: each (task, source) goes to ONE compute
      node (the LP relaxation rounded to its argmax);
    * data flow capped at `saturate` × capacity on queueing links and
      compute units; result flow takes shortest paths, uncapped;
    * evaluated under the true convex cost of the resulting flows.

    The flows are built in float64 on the host, cast to float32 for the
    cost, which is summed on the host in float32, as the reference
    does."""
    adj = net.adj.cpu().numpy()
    V = net.V
    dist, nxt = all_pairs_next_hop(adj, _zero_flow_weights(net))
    dests = _numpy(net.dest)
    r, a, wmat = _numpy(net.r), _numpy(net.a), _numpy(net.w)
    Cp0 = _numpy(net.comp_cost.d1(torch.zeros(V, device=net.device)))

    pairs = [(s, i) for s in range(net.S) for i in range(V) if r[s, i] > 0]
    nP = len(pairs)

    # objective coefficients c[(s, i), k]
    c = np.zeros((nP, V))
    for p, (s, i) in enumerate(pairs):
        c[p] = r[s, i] * (dist[i] + wmat[s] * Cp0 + a[s] * dist[:, dests[s]])

    x = None
    if nP * V <= max_lp_vars:
        x = _solve_lp(net, pairs, c, dist, nxt, saturate)
    if x is None:
        x = _greedy_assign(net, pairs, c, saturate)
    choice = np.argmax(x, axis=1)    # one compute node per (task, source)

    # the true flows along shortest paths
    F = np.zeros((V, V))
    G = np.zeros(V)
    hops_d, hops_r, mass = 0.0, 0.0, 0.0
    for p, (s, i) in enumerate(pairs):
        k = int(choice[p])
        rate = r[s, i]
        pd = _path(nxt, i, k) or []
        pr = _path(nxt, k, int(dests[s])) or []
        for (u, v) in pd:
            F[u, v] += rate
        for (u, v) in pr:
            F[u, v] += a[s] * rate
        G[k] += wmat[s, k] * rate
        hops_d += rate * len(pd)
        hops_r += rate * len(pr)
        mass += rate

    dev = net.device
    link_v = net.link_cost.value(torch.as_tensor(F.astype(np.float32),
                                                 device=dev))
    comp_v = net.comp_cost.value(torch.as_tensor(G.astype(np.float32),
                                                 device=dev))
    link = np.where(adj, _numpy(link_v), 0.0)
    T = float(np.sum(link) + np.sum(_numpy(comp_v)))
    return {"final_cost": T, "F": F, "G": G,
            "L_data": hops_d / max(mass, 1e-12),
            "L_result": hops_r / max(mass, 1e-12)}


def _solve_lp(net, pairs, c, dist, nxt, saturate):
    from scipy.optimize import linprog
    from scipy.sparse import lil_matrix, vstack
    adj = net.adj.cpu().numpy()
    V = net.V
    r, wmat = _numpy(net.r), _numpy(net.w)
    nP = len(pairs)
    n = nP * V

    A_eq = lil_matrix((nP, n))
    for p in range(nP):
        A_eq[p, p * V:(p + 1) * V] = 1.0
    b_eq = np.ones(nP)

    rows, caps = [], []
    if net.link_cost.family == "queue":
        edges = [(u, v) for u in range(V) for v in range(V) if adj[u, v]]
        eidx = {e: q for q, e in enumerate(edges)}
        A_l = lil_matrix((len(edges), n))
        used = np.zeros(len(edges), dtype=bool)
        for p, (s, i) in enumerate(pairs):
            for k in range(V):
                pd = _path(nxt, i, k)
                if pd is None:
                    continue
                for e in pd:
                    q = eidx[e]
                    A_l[q, p * V + k] += r[s, i]
                    used[q] = True
        capl = (saturate * _numpy(net.link_cost.params)[tuple(zip(*edges))]
                if edges else np.zeros(0))
        keep = np.where(used)[0]
        if len(keep):
            rows.append(A_l.tocsr()[keep])
            caps.append(capl[keep])
    if net.comp_cost.family == "queue":
        A_c = lil_matrix((V, n))
        for p, (s, i) in enumerate(pairs):
            for k in range(V):
                A_c[k, p * V + k] = wmat[s, k] * r[s, i]
        rows.append(A_c.tocsr())
        caps.append(saturate * _numpy(net.comp_cost.params))

    A_ub, b_ub = ((vstack(rows), np.concatenate(caps)) if rows
                  else (None, None))
    res = linprog(c.ravel(), A_ub=A_ub, b_ub=b_ub, A_eq=A_eq.tocsr(),
                  b_eq=b_eq, bounds=(0, 1), method="highs")
    if not res.success:
        return None
    return res.x.reshape(nP, V)


def _greedy_assign(net, pairs, c, saturate):
    """Capacity-respecting greedy assignment for large instances: the
    heaviest (task, source) first, each to its cheapest node with room
    (or the least loaded one)."""
    V = net.V
    r, wmat = _numpy(net.r), _numpy(net.w)
    cap = (saturate * _numpy(net.comp_cost.params)
           if net.comp_cost.family == "queue" else np.full(V, np.inf))
    load = np.zeros(V)
    x = np.zeros((len(pairs), V))
    order = np.argsort([-r[s, i] for (s, i) in pairs])
    for p in order:
        s, i = pairs[p]
        best = None
        for k in np.argsort(c[p]):
            if load[k] + wmat[s, k] * r[s, i] <= cap[k]:
                best = k
                break
        if best is None:
            best = int(np.argmin(load / np.maximum(cap, 1e-12)))
        x[p, best] = 1.0
        load[best] += wmat[s, best] * r[s, i]
    return x


# ------------------------------------------------------------------ summary
def run_all(net: CECNetwork, n_iters: int = 200, min_scale: float = 0.05
            ) -> Dict[str, float]:
    """The Fig. 4 driver: the final total cost of each algorithm on one
    scenario (the SGP runs on the default dense engine and driver)."""
    out = {}
    _, h = sgp.run(net, spt_phi(net), n_iters=n_iters, variant="sgp",
                   min_scale=min_scale)
    out["SGP"] = h["final_cost"]
    _, h = run_spoo(net, n_iters=n_iters)
    out["SPOO"] = h["final_cost"]
    _, h = run_lcor(net, n_iters=n_iters)
    out["LCOR"] = h["final_cost"]
    out["LPR"] = run_lpr(net)["final_cost"]
    return out
