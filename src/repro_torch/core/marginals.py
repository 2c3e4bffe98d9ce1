"""Marginal-cost recursions (paper Eq. 9-13).

  ρ⁺_i = Σ_j φ⁺_ij (D'_ij + ρ⁺_j)                         (Eq. 12)
  ρ⁻_i = Σ_j φ⁻_ij (D'_ij + ρ⁻_j) + φ⁻_i0 (w_i C'_i + a ρ⁺_i)  (Eq. 11)
  δ⁺_ij = D'_ij + ρ⁺_j,  δ⁻_ij = D'_ij + ρ⁻_j,  δ⁻_i0 = w_i C'_i + a ρ⁺_i

Three evaluations, as in the reference: "dense" (one batched LU solve),
"broadcast" (the paper's rounds on dense [S, V, V] arrays) and "sparse"
(out-edge message passing in the [S, V, Dmax] slot layout; δ and D'
then come back on the slots too).  Non-edges and padded slots of δ are
pinned to BIG so no argmin picks them.
"""
from __future__ import annotations

import dataclasses

import torch

from .network import (CECNetwork, Neighbors, Phi, PhiSparse,
                      _phi_edge_views, _solve_dense, _solve_fp_broadcast,
                      build_neighbors, check_method, gather_edges,
                      link_cost_sparse, mask_slots, solve_downstream_sparse)

BIG = 1e12  # marginal cost of non-edges (never selected)


@dataclasses.dataclass(frozen=True)
class Marginals:
    """Dense: δ⁻ [S, V, V+1], δ⁺ [S, V, V], D' [V, V]; sparse: δ⁻
    [S, V, Dmax+1], δ⁺ [S, V, Dmax], D' [V, Dmax] on the slots (padding
    0).  The last column of δ⁻ is the local one."""
    rho_data: torch.Tensor      # [S, V]
    rho_result: torch.Tensor    # [S, V]
    delta_data: torch.Tensor
    delta_result: torch.Tensor
    Dp: torch.Tensor
    Cp: torch.Tensor            # [V] C'_i


def _solve_downstream(phi_nbr, b, method: str):
    """ρ = b + Φ ρ (not transposed: the recursion runs downstream)."""
    if method == "dense":
        eye = torch.eye(phi_nbr.shape[-1], dtype=phi_nbr.dtype,
                        device=phi_nbr.device)
        return _solve_dense(eye[None] - phi_nbr, b)
    if method == "broadcast":
        return _solve_fp_broadcast(phi_nbr, b, False)
    raise ValueError(f"unknown method {method!r}")


def _mask_inactive(mg: Marginals, active: torch.Tensor) -> Marginals:
    """ρ rows of inactive task slots zeroed (inert slots carry no rate,
    so nothing reads them; a padded pool leaks nothing through them)."""
    am = active[:, None]
    return dataclasses.replace(
        mg, rho_data=torch.where(am, mg.rho_data, 0.0),
        rho_result=torch.where(am, mg.rho_result, 0.0))


def compute_marginals(net: CECNetwork, phi, fl, method: str = "dense",
                      nbrs: Neighbors | None = None,
                      slot_F: bool = False, buckets=None,
                      active: torch.Tensor | None = None) -> Marginals:
    """`phi` is a dense `Phi`, or (method="sparse" only) a `PhiSparse`.
    slot_F=True (sparse) declares `fl.F` the [V, Dmax] slot link flow of
    a driver `FlowsCarry`; otherwise `fl.F` is the dense [V, V] flow.
    `active` ([S] bool, a task pool's mask) zeroes the ρ rows of inactive
    slots; δ, D' and C' are unaffected (inert slots carry no flow)."""
    check_method(method)
    if isinstance(phi, PhiSparse) and method != "sparse":
        raise ValueError("PhiSparse requires method='sparse'")
    if method == "sparse":
        nbrs = nbrs if nbrs is not None else build_neighbors(net.adj)
        mg = _compute_marginals_sparse(net, phi, fl, nbrs, slot_F=slot_F,
                                       buckets=buckets)
        return mg if active is None else _mask_inactive(mg, active)
    adjf = net.adj.to(phi.data.dtype)
    Dp = torch.where(net.adj, net.link_cost.d1(fl.F), 0.0)
    Cp = net.comp_cost.d1(fl.G)
    phi_d_nbr = phi.data[..., :-1] * adjf[None]
    phi_loc = phi.data[..., -1]
    phi_r = phi.result * adjf[None]

    # stage 1: result marginals, from the destination upstream
    b_r = torch.einsum("sij,ij->si", phi_r, Dp)
    rho_result = _solve_downstream(phi_r, b_r, method)

    # stage 2: data marginals (need ρ⁺ first)
    delta_local = net.w * Cp[None] + net.a[:, None] * rho_result
    b_d = torch.einsum("sij,ij->si", phi_d_nbr, Dp) + phi_loc * delta_local
    rho_data = _solve_downstream(phi_d_nbr, b_d, method)

    ninf = torch.where(net.adj, 0.0, BIG)[None]
    delta_result = Dp[None] + rho_result[:, None, :] + ninf
    delta_data_nbr = Dp[None] + rho_data[:, None, :] + ninf
    delta_data = torch.cat([delta_data_nbr, delta_local[..., None]], dim=-1)
    mg = Marginals(rho_data, rho_result, delta_data, delta_result, Dp, Cp)
    return mg if active is None else _mask_inactive(mg, active)


def _compute_marginals_sparse(net: CECNetwork, phi, fl, nbrs: Neighbors,
                              slot_F: bool = False,
                              buckets=None) -> Marginals:
    if slot_F:
        Dp_sp = mask_slots(link_cost_sparse(net, nbrs).d1(fl.F), nbrs)
    else:
        Dp_sp = gather_edges(net.link_cost.d1(fl.F), nbrs)
    Cp = net.comp_cost.d1(fl.G)

    phi_d_sp, phi_loc, phi_r_sp = _phi_edge_views(phi, nbrs)

    # stage 1: result marginals, from the destination upstream
    b_r = torch.sum(phi_r_sp * Dp_sp[None], dim=-1)
    rho_result = solve_downstream_sparse(phi_r_sp, b_r, nbrs,
                                         buckets=buckets)

    # stage 2: data marginals (need ρ⁺ first)
    delta_local = net.w * Cp[None] + net.a[:, None] * rho_result
    b_d = torch.sum(phi_d_sp * Dp_sp[None], dim=-1) + phi_loc * delta_local
    rho_data = solve_downstream_sparse(phi_d_sp, b_d, nbrs,
                                       buckets=buckets)

    ninf = torch.where(nbrs.out_mask, 0.0, BIG)[None]
    delta_result = Dp_sp[None] + rho_result[:, nbrs.out_nbr] + ninf
    delta_data_nbr = Dp_sp[None] + rho_data[:, nbrs.out_nbr] + ninf
    delta_data = torch.cat([delta_data_nbr, delta_local[..., None]], dim=-1)
    return Marginals(rho_data, rho_result, delta_data, delta_result, Dp_sp,
                     Cp)


def phi_gradients(net: CECNetwork, phi: Phi, fl, mg: Marginals):
    """The Lemma-1 gradients ∂T/∂φ = t ⊙ δ (Eq. 9-10)."""
    gd = fl.t_data[..., None] * mg.delta_data
    gr = fl.t_result[..., None] * mg.delta_result
    return gd, gr
