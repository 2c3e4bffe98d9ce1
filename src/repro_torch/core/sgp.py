"""Algorithm 1 — Scaled Gradient Projection (paper §IV), sparse engine.

Per iteration, for every (node, task) row, the driver
  1. reuses the iterate's carried flows (Eq. 1-2, solved when the
     iterate was proposed),
  2. solves the result and data marginal recursions (Eq. 9-13),
  3. builds the blocked sets from the taint closure (loop freedom),
  4. projects every row onto the scaled simplex (the Eq. 15 QP) with
     the current-flow curvature times the safeguard factor σ as the
     diagonal scaling (`scaling="adaptive"`, κ = 0),
  5. measures the candidate's flows and cost and accepts it only if
     the cost does not rise (σ grows ×4 on a rejection and decays
     toward 1 on an acceptance).

The recursions run through `kernels.ops.edge_rounds` (or its bucketed
form) and the QPs through `kernels.ops.simplex_project`: the Hopper
kernels for tensors on the card, their plain versions on the CPU.  The
driver is the per-iteration host loop of the JAX package's `run_chunk`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels import ops as kernel_ops
from .marginals import BIG, Marginals, compute_marginals
from .network import (CECNetwork, FlowsCarry, Neighbors, PhiSparse,
                      _phi_edge_views, _sparse_only, build_buckets,
                      build_neighbors, flows_carry_and_cost,
                      link_cost_sparse, mask_slots)

SUPPORT_TOL = 1e-9   # φ below this is treated as zero support
SNAP_TOL = 1e-12     # post-projection snap-to-zero
TRAFFIC_EPS = 1e-9   # rows with traffic below this take the one-hot jump
# σ's decay as an explicit float32 reciprocal multiply, as the reference
SIGMA_DECAY = np.float32(1.0 / 1.5)


@dataclasses.dataclass(frozen=True)
class SGPConsts:
    """Iteration-invariant constants of Algorithm 1 (line 2)."""
    A_link: torch.Tensor     # [V, V] sup D''_ij on the T0-sublevel set
    A_comp: torch.Tensor     # [V]    sup C''_i on the T0-sublevel set
    A_max: torch.Tensor      # scalar A(T0)
    min_scale: torch.Tensor  # scalar floor on diag(M)/t


def make_consts(net: CECNetwork, T0: torch.Tensor,
                min_scale: float = 0.05) -> SGPConsts:
    A_link = torch.where(net.adj, net.link_cost.d2_sup(T0), 0.0)
    A_comp = net.comp_cost.d2_sup(T0)
    A_max = torch.maximum(A_link.max(), A_comp.max())
    return SGPConsts(A_link, A_comp, A_max,
                     torch.tensor(min_scale, dtype=torch.float32,
                                  device=net.device))


def _project(phi_rows, delta, M, permitted):
    """The [S, V, K] batch of Eq. 15 QPs, flattened to [S·V, K] rows."""
    S, V, K = phi_rows.shape
    out = kernel_ops.simplex_project(
        phi_rows.reshape(S * V, K), delta.reshape(S * V, K),
        M.reshape(S * V, K), permitted.reshape(S * V, K))
    return out.reshape(S, V, K)


# ------------------------------------------------------------ blocked sets
def _taint_pair_sparse(sup_a, rho_a, sup_b, rho_b, nbrs: Neighbors,
                       buckets=None):
    """Both taint closures (data + result) in ONE stacked launch.

    A node is tainted if some support path from it holds an improper
    edge (ρ_j >= ρ_i).  The boolean-or closure is a max recursion on a
    {0, 1} encoding, carried in bfloat16 (exact for 0 and 1)."""
    dt = torch.bfloat16

    def has_improper(sup, rho):
        improper = sup & (rho[:, nbrs.out_nbr] >= rho[:, :, None])
        return improper.any(-1)

    t_a, t_b = kernel_ops.edge_rounds_stacked(
        [(sup_a.to(dt), has_improper(sup_a, rho_a).to(dt)),
         (sup_b.to(dt), has_improper(sup_b, rho_b).to(dt))],
        nbrs.out_nbr, nbrs.out_mask, reduce="max", max_rounds=nbrs.V,
        buckets=buckets.out if buckets is not None else None)
    return t_a > 0.5, t_b > 0.5


def blocked_sets_sparse(net: CECNetwork, phi, mg: Marginals,
                        nbrs: Neighbors, buckets=None):
    """Permitted masks on the slots: data [S, V, Dmax+1] (last column
    local, always permitted), result [S, V, Dmax] (none at a task's
    destination).  A new edge (no support yet) is blocked if it goes
    uphill in ρ or toward a tainted node; support edges stay permitted."""
    phi_d_sp, _, phi_r_sp = _phi_edge_views(phi, nbrs)
    sup_d = phi_d_sp > SUPPORT_TOL
    sup_r = phi_r_sp > SUPPORT_TOL
    taint_d, taint_r = _taint_pair_sparse(sup_d, mg.rho_data, sup_r,
                                          mg.rho_result, nbrs,
                                          buckets=buckets)

    def permitted(sup, rho, taint):
        uphill = rho[:, nbrs.out_nbr] >= rho[:, :, None]
        block_new = (~sup) & (uphill | taint[:, nbrs.out_nbr])
        return nbrs.out_mask[None] & ~block_new

    perm_d_nbr = permitted(sup_d, mg.rho_data, taint_d)
    perm_r = permitted(sup_r, mg.rho_result, taint_r)
    S, V = net.S, net.V
    perm_d = torch.cat([perm_d_nbr, torch.ones((S, V, 1), dtype=torch.bool,
                                               device=net.device)], dim=-1)
    perm_r = torch.where(_is_dest(net)[..., None], False, perm_r)
    return perm_d, perm_r


def _is_dest(net: CECNetwork) -> torch.Tensor:
    return torch.arange(net.V, device=net.device)[None] == net.dest[:, None]


# ---------------------------------------------------------------- the step
def _onehot_min(delta, perm, dtype):
    """Zero-traffic rows jump one-hot to the δ-argmin over permitted
    coordinates; fully blocked rows stay all zero."""
    d = torch.where(perm, delta, BIG)
    oh = torch.nn.functional.one_hot(d.argmin(-1), d.shape[-1]).to(dtype)
    return torch.where(perm.any(-1, keepdim=True), oh, 0.0)


def _sgp_propose_impl(net: CECNetwork, phi: PhiSparse, fl: FlowsCarry,
                      consts: SGPConsts, sigma: float = 1.0,
                      nbrs: Optional[Neighbors] = None, buckets=None):
    """The projection half of one iteration: from the iterate and its
    carried flows, the marginals, blocked sets, Eq. 16 scaling (adaptive,
    κ = 0) and the projected candidate.  Returns (phi_new, marginals)."""
    mg = compute_marginals(net, phi, fl, nbrs=nbrs, slot_F=True,
                           buckets=buckets)
    phi_d_sp, phi_loc, phi_r_rows = _phi_edge_views(phi, nbrs)
    phi_d_rows = torch.cat([phi_d_sp, phi_loc[..., None]], dim=-1)
    perm_d, perm_r = blocked_sets_sparse(net, phi, mg, nbrs,
                                         buckets=buckets)

    # current-flow curvature on the slots, times the safeguard σ; with
    # κ = 0 the Eq. 16 cross terms vanish and this is the whole diagonal
    sigma = float(np.float32(sigma))
    A_link_e = (mask_slots(link_cost_sparse(net, nbrs).d2(fl.F), nbrs)
                * sigma)[None]
    A_comp = net.comp_cost.d2(fl.G) * sigma
    diag_r = A_link_e
    diag_d = torch.cat([A_link_e, A_comp[None, :, None]], dim=-1)
    Mr = 0.5 * fl.t_result[..., None] * diag_r
    Md = 0.5 * fl.t_data[..., None] * diag_d
    # floor for flat (linear) costs: behaves like conservative GP
    Mr = torch.maximum(Mr, consts.min_scale * fl.t_result[..., None])
    Md = torch.maximum(Md, consts.min_scale * fl.t_data[..., None])

    new_d = _project(phi_d_rows, mg.delta_data, Md, perm_d)
    new_r = _project(phi_r_rows, mg.delta_result, Mr, perm_r)

    jump_d = _onehot_min(mg.delta_data, perm_d, phi.data.dtype)
    jump_r = _onehot_min(mg.delta_result, perm_r, phi.result.dtype)
    new_d = torch.where((fl.t_data > TRAFFIC_EPS)[..., None], new_d, jump_d)
    new_r = torch.where((fl.t_result > TRAFFIC_EPS)[..., None], new_r, jump_r)
    new_r = torch.where(_is_dest(net)[..., None], 0.0, new_r)
    return PhiSparse(new_d[..., :-1], new_d[..., -1:], new_r), mg


def _sgp_step_flows_impl(net: CECNetwork, phi: PhiSparse, fl: FlowsCarry,
                         consts: SGPConsts, sigma: float = 1.0,
                         nbrs: Optional[Neighbors] = None, buckets=None):
    """One driver iteration: propose from the carried flows, then
    measure the candidate.  Returns (phi_new, carry_new, cost_new)."""
    phi_new, _ = _sgp_propose_impl(net, phi, fl, consts, sigma=sigma,
                                   nbrs=nbrs, buckets=buckets)
    carry_new, cost_new = flows_carry_and_cost(net, phi_new, nbrs=nbrs,
                                               buckets=buckets)
    return phi_new, carry_new, cost_new


# ------------------------------------------------------------------ driver
def accept_step(new_cost: float, prev_cost: float, sigma: float):
    """Accept/reject rule and σ safeguard, in float32 like the reference.

    A non-finite or uphill cost is rejected and σ quadrupled (stopping
    past 1e12); an accepted step decays σ toward 1.  Returns (accepted,
    sigma, stopped)."""
    new32, prev32 = np.float32(new_cost), np.float32(prev_cost)
    accepted = bool(np.isfinite(new32)) and not (
        new32 > prev32 * np.float32(1.0 + 1e-12))
    stopped = False
    sigma32 = np.float32(sigma)
    if not accepted:
        sigma32 = sigma32 * np.float32(4.0)
        if sigma32 > np.float32(1e12):
            stopped = True
    else:
        sigma32 = max(sigma32 * SIGMA_DECAY, np.float32(1.0))
    return accepted, float(sigma32), stopped


def _tol_converged(costs: list, tol: float) -> bool:
    """|c[-2] - c[-1]| <= tol · max(c[-1], 1e-12) in float32, armed once
    more than 4 costs accumulated; applied after accepted steps only."""
    if not (tol > 0.0 and len(costs) > 4):
        return False
    c2, c1 = np.float32(costs[-2]), np.float32(costs[-1])
    return bool(abs(c2 - c1)
                <= np.float32(tol) * max(c1, np.float32(1e-12)))


@dataclasses.dataclass
class RunState:
    """Resumable host-side state of the driver: `run_chunk` continues
    exactly where the previous chunk stopped."""
    phi: PhiSparse
    consts: SGPConsts
    nbrs: Neighbors
    costs: list
    min_scale: float = 0.05
    sigma: float = 1.0
    n_rejected: int = 0
    it: int = 0                     # iterations executed so far
    stopped: bool = False           # σ blow-up / tol early exit
    flows: Optional[FlowsCarry] = None   # flows of `phi`
    buckets: object = None          # NeighborBuckets (bucketed mode)


def init_run_state(net: CECNetwork, phi0: PhiSparse, min_scale: float = 0.05,
                   method: str = "sparse",
                   nbrs: Optional[Neighbors] = None, bucketed: bool = False,
                   buckets=None) -> RunState:
    """Build (or accept) the neighbour lists and, with bucketed=True, the
    degree buckets; evaluate φ⁰'s flows and cost T⁰ (one solve, both
    carried) and the Eq. 16 constants."""
    _sparse_only(method)
    if not isinstance(phi0, PhiSparse):
        raise TypeError("the driver iterates an edge-slot PhiSparse "
                        "(see spt_phi_sparse / phi_to_sparse)")
    nbrs = build_neighbors(net.adj) if nbrs is None else nbrs
    if bucketed and buckets is None:
        buckets = build_buckets(net.adj)
    fl0, T0 = flows_carry_and_cost(net, phi0, nbrs=nbrs, buckets=buckets)
    return RunState(phi=phi0, consts=make_consts(net, T0, min_scale),
                    nbrs=nbrs, costs=[float(T0)], min_scale=min_scale,
                    flows=fl0, buckets=buckets)


def run_chunk(net: CECNetwork, state: RunState, n_iters: int,
              tol: float = 0.0) -> RunState:
    """Advance the host driver `n_iters` iterations, updating `state` in
    place.  One host sync an iteration (the candidate's cost)."""
    if state.stopped or n_iters <= 0:
        return state
    phi, fl, costs = state.phi, state.flows, state.costs
    sigma, n_rejected, done = state.sigma, state.n_rejected, state.it
    for it in range(state.it, state.it + n_iters):
        done = it + 1
        phi_new, fl_new, cost_new = _sgp_step_flows_impl(
            net, phi, fl, state.consts, sigma=sigma, nbrs=state.nbrs,
            buckets=state.buckets)
        new_cost = float(cost_new)
        accepted, sigma, stop = accept_step(new_cost, costs[-1], sigma)
        if not accepted:
            n_rejected += 1
            if stop:
                state.stopped = True
                break
        else:
            phi, fl = phi_new, fl_new
            costs.append(new_cost)
        if accepted and _tol_converged(costs, tol):
            state.stopped = True
            break
    state.phi, state.flows = phi, fl
    state.sigma, state.n_rejected, state.it = sigma, n_rejected, done
    return state


def run(net: CECNetwork, phi0: PhiSparse, n_iters: int = 200,
        min_scale: float = 0.05, method: str = "sparse", tol: float = 0.0,
        bucketed: bool = False, nbrs: Optional[Neighbors] = None,
        buckets=None):
    """Algorithm 1 from φ⁰ for `n_iters` iterations (or until σ blows up
    or the tol exit fires).  bucketed=True runs every recursion over
    degree buckets — bitwise the padded trajectory.  `nbrs` and `buckets`
    take tiles already built (`build_neighbors`, `build_buckets`; given
    buckets are used as init_run_state uses them), so the run reads
    nothing of the adjacency back to the host.  Returns
    (phi_final, {"costs", "final_cost", "n_rejected"})."""
    state = init_run_state(net, phi0, min_scale=min_scale, method=method,
                           nbrs=nbrs, bucketed=bucketed, buckets=buckets)
    state = run_chunk(net, state, n_iters, tol=tol)
    return state.phi, {"costs": state.costs, "final_cost": state.costs[-1],
                       "n_rejected": state.n_rejected}
