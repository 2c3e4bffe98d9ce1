"""Marginal-cost recursions (paper Eq. 9-13) on the sparse engine.

  ρ⁺_i = Σ_j φ⁺_ij (D'_ij + ρ⁺_j)                         (Eq. 12)
  ρ⁻_i = Σ_j φ⁻_ij (D'_ij + ρ⁻_j) + φ⁻_i0 (w_i C'_i + a ρ⁺_i)  (Eq. 11)
  δ⁺_ij = D'_ij + ρ⁺_j,  δ⁻_ij = D'_ij + ρ⁻_j,  δ⁻_i0 = w_i C'_i + a ρ⁺_i

as out-edge message passing in the [S, V, Dmax] slot layout; padded
slots of δ are pinned to BIG so no argmin picks them.
"""
from __future__ import annotations

import dataclasses

import torch

from .network import (CECNetwork, Neighbors, _phi_edge_views, _sparse_only,
                      build_neighbors, gather_edges, link_cost_sparse,
                      mask_slots, solve_downstream_sparse)

BIG = 1e12  # marginal cost of non-edges (never selected)


@dataclasses.dataclass(frozen=True)
class Marginals:
    rho_data: torch.Tensor      # [S, V]
    rho_result: torch.Tensor    # [S, V]
    delta_data: torch.Tensor    # [S, V, Dmax+1] (last column local)
    delta_result: torch.Tensor  # [S, V, Dmax]
    Dp: torch.Tensor            # [V, Dmax] D'_ij on slots (padding 0)
    Cp: torch.Tensor            # [V] C'_i


def compute_marginals(net: CECNetwork, phi, fl, method: str = "sparse",
                      nbrs: Neighbors | None = None,
                      slot_F: bool = False, buckets=None) -> Marginals:
    """slot_F=True declares `fl.F` the [V, Dmax] slot link flow of a
    driver `FlowsCarry`; otherwise `fl.F` is the dense [V, V] flow."""
    _sparse_only(method)
    nbrs = nbrs if nbrs is not None else build_neighbors(net.adj)
    return _compute_marginals_sparse(net, phi, fl, nbrs, slot_F=slot_F,
                                     buckets=buckets)


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
