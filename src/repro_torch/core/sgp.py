"""Algorithm 1 — Scaled Gradient Projection (paper §IV).

Per iteration, for every (node, task) row, the driver
  1. reuses the iterate's carried flows (Eq. 1-2, solved when the
     iterate was proposed),
  2. solves the result and data marginal recursions (Eq. 9-13),
  3. builds the blocked sets from the taint closure (loop freedom),
  4. projects every row onto the scaled simplex (the Eq. 15 QP) with
     the Eq. 16 diagonal scaling: the current-flow curvature times the
     safeguard factor σ (`scaling="adaptive"`) or the T⁰-sublevel sup
     constants (`scaling="paper"`), plus the κ·n·h·A cross terms whose
     path lengths h come from the longest-path recursion (κ > 0), or
     Gallager's unscaled GP rule (`variant="gp"`),
  5. measures the candidate's flows and cost and accepts it only if
     the cost does not rise (adaptive SGP; σ grows ×4 on a rejection
     and decays toward 1 on an acceptance).

The step runs on one of the flow model's engines (`method=`, the
reference's default "dense"): "dense" and "broadcast" iterate the dense
`Phi` with the LU or round-by-round solves and the V-round taint and
path-length scans on [S, V, V] arrays; "sparse" iterates the edge-slot
`PhiSparse`, its recursions through `kernels.ops.edge_rounds` (or its
bucketed form).  Every engine projects its rows through
`kernels.ops.simplex_project` (the dense rows [S·V, V+1] and [S·V, V],
the sparse ones [S·V, Dmax+1] and [S·V, Dmax]): the Hopper kernel for
tensors on the card, its plain version on the CPU.

Two drivers walk the same trajectory bit for bit.  `driver="host"` is
the per-iteration loop that reads each candidate's cost back to decide.
`driver="fused"` (the default without a callback) keeps the accept,
σ and tol decisions on the device as branchless selects and reads the
chunk's costs back once at its end; on the card its iteration is
captured once into a CUDA graph and replayed.  Fault injection
(`core.faults`) and the guards' sentinels and rollback (`core.guards`)
ride the fused driver's carry (`fault_plan`, `fault_rng` and `guards` of
`run` and `init_run_state`).  The task-sharded driver
(`core.distributed`) runs both drivers on a rank's task shard with a
`TaskMesh` in the step (`mesh=`), whose one all-reduce of F and G
couples the shards.
"""
from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Optional

import numpy as np
import torch

from ..kernels import ops as kernel_ops
from ..kernels.ref import simplex_project_ref
from . import faults as _faults
from .faults import FaultState, init_fault_state
from .marginals import BIG, Marginals, compute_marginals
from .network import (CECNetwork, FlowsCarry, Neighbors, Phi, PhiSparse,
                      _phi_edge_views, build_buckets, build_neighbors,
                      check_method, compute_flows, cost_of_flows,
                      flows_carry_and_cost, gather_edges, link_cost_sparse,
                      mask_slots, phi_to_sparse, scatter_edges,
                      sparse_to_phi)

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


def _curvature_sups(net: CECNetwork, T0: torch.Tensor):
    A_link = torch.where(net.adj, net.link_cost.d2_sup(T0), 0.0)
    A_comp = net.comp_cost.d2_sup(T0)
    return A_link, A_comp, torch.maximum(A_link.max(), A_comp.max())


def make_consts(net: CECNetwork, T0: torch.Tensor,
                min_scale: float = 0.05) -> SGPConsts:
    return SGPConsts(*_curvature_sups(net, T0),
                     torch.tensor(min_scale, dtype=torch.float32,
                                  device=net.device))


def _f32(x, device) -> torch.Tensor:
    """A float32 scalar on `device`, written by a fill (no host copy)."""
    return torch.full((), float(np.float32(x)), dtype=torch.float32,
                      device=device)


def _fields(x) -> tuple:
    """A dataclass's tensors, in field order (no copies)."""
    return tuple(getattr(x, f.name) for f in dataclasses.fields(x))


def _one_hot(idx: torch.Tensor, K: int, dtype) -> torch.Tensor:
    return (torch.arange(K, device=idx.device) == idx[..., None]).to(dtype)


# the reference's plain QP oracle (`core/sgp.py:project_rows`): the same
# function as K3's plain version
project_rows = simplex_project_ref


def _project(phi_rows, delta, M, permitted):
    """The [S, V, K] batch of Eq. 15 QPs, flattened to [S·V, K] rows."""
    S, V, K = phi_rows.shape
    out = kernel_ops.simplex_project(
        phi_rows.reshape(S * V, K), delta.reshape(S * V, K),
        M.reshape(S * V, K), permitted.reshape(S * V, K))
    return out.reshape(S, V, K)


def gp_rows(phi_row, delta, t, permitted, beta: float):
    """Gallager's unscaled GP row update (paper §V): non-minimal
    coordinates move down by β(δ_j − δ_min)/(2t), clipped at 0; the
    δ-argmin coordinate absorbs the released mass.  Fully blocked rows
    come back all zero."""
    d = torch.where(permitted, delta, BIG)
    onehot = _one_hot(d.argmin(-1), d.shape[-1], phi_row.dtype)
    dmin = d.min(-1, keepdim=True).values
    phi0 = torch.where(permitted, phi_row, 0.0)
    step = beta * (d - dmin) / (2.0 * torch.clamp_min(t[..., None],
                                                      TRAFFIC_EPS))
    v = torch.clamp_min(phi0 - step, 0.0) * (1.0 - onehot)
    v = torch.where(permitted, v, 0.0)
    v = v + onehot * (1.0 - v.sum(-1, keepdim=True))
    v = torch.where(v > SNAP_TOL, v, 0.0)
    s = v.sum(-1, keepdim=True)
    v = torch.where(s > 0.0, v / torch.clamp_min(s, 1e-30), onehot)
    return torch.where(permitted.any(-1, keepdim=True), v, 0.0)


# ------------------------------------------------------------ blocked sets
def _taint(sup, rho):
    """[S, V] bool: the node has an improper edge (ρ_j >= ρ_i on its
    support) on some downstream support path: V rounds of the boolean
    closure over [S, V, V], as the reference's scan."""
    improper = sup & (rho[:, None, :] >= rho[:, :, None])
    has_improper = improper.any(-1)
    t = has_improper
    for _ in range(sup.shape[-1]):
        t = has_improper | (sup & t[:, None, :]).any(-1)
    return t


def blocked_sets(net: CECNetwork, phi: Phi, mg: Marginals):
    """Permitted masks of the dense engine: data [S, V, V+1] (the local
    column always permitted), result [S, V, V] (none at a task's
    destination).  A new edge is blocked if it goes uphill in ρ or
    toward a tainted node; support edges stay permitted."""
    adj = net.adj[None]
    sup_d = (phi.data[..., :-1] > SUPPORT_TOL) & adj
    sup_r = (phi.result > SUPPORT_TOL) & adj
    taint_d = _taint(sup_d, mg.rho_data)
    taint_r = _taint(sup_r, mg.rho_result)

    def permitted(sup, rho, taint):
        uphill = rho[:, None, :] >= rho[:, :, None]
        block_new = (~sup) & (uphill | taint[:, None, :])
        return adj & ~block_new

    perm_d_nbr = permitted(sup_d, mg.rho_data, taint_d)
    perm_r = permitted(sup_r, mg.rho_result, taint_r)
    S, V = net.S, net.V
    perm_d = torch.cat([perm_d_nbr, torch.ones((S, V, 1), dtype=torch.bool,
                                               device=net.device)], dim=-1)
    perm_r = torch.where(_is_dest(net)[..., None], False, perm_r)
    return perm_d, perm_r


def _max_path_len(sup):
    """h[s, i], the longest support path (in hops) from i, by V rounds of
    h <- max_j sup_ij (1 + h_j) over [S, V, V]; terminals have h = 0."""
    h = torch.zeros(sup.shape[:2], dtype=torch.float32, device=sup.device)
    for _ in range(sup.shape[-1]):
        h = torch.where(sup, 1.0 + h[:, None, :], 0.0).amax(-1)
    return h


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


def _max_path_len_sparse(sup, nbrs: Neighbors, buckets=None):
    """h[s, i], the longest support path (in hops) from i: a max reduce
    over 1 + h[nbr] (shift = 1) from a zero inject; rows without
    outgoing support have h = 0."""
    return _max_path_len_pair_sparse(sup, None, nbrs, buckets)[0]


def _max_path_len_pair_sparse(sup_a, sup_b, nbrs: Neighbors, buckets=None):
    """Both longest-path recursions (result + data) in ONE stacked
    launch, bit for bit the unstacked solves (`sup_b=None`: one)."""
    h0 = torch.zeros(sup_a.shape[:2], dtype=torch.float32,
                     device=sup_a.device)
    problems = [(s.to(torch.float32), h0) for s in (sup_a, sup_b)
                if s is not None]
    return kernel_ops.edge_rounds_stacked(
        problems, nbrs.out_nbr, nbrs.out_mask, reduce="max", shift=1.0,
        max_rounds=nbrs.V,
        buckets=buckets.out if buckets is not None else None)


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
    oh = _one_hot(d.argmin(-1), d.shape[-1], dtype)
    return torch.where(perm.any(-1, keepdim=True), oh, 0.0)


def _sgp_propose_impl(net: CECNetwork, phi, fl: FlowsCarry,
                      consts: SGPConsts, variant: str = "sgp",
                      beta: float = 1.0,
                      mask_data: Optional[torch.Tensor] = None,
                      mask_result: Optional[torch.Tensor] = None,
                      allowed_data: Optional[torch.Tensor] = None,
                      allowed_result: Optional[torch.Tensor] = None,
                      method: str = "dense", use_blocking: bool = True,
                      scaling: str = "adaptive", sigma=1.0,
                      kappa: float = 0.0,
                      nbrs: Optional[Neighbors] = None, buckets=None,
                      mg: Optional[Marginals] = None):
    """The projection half of one iteration: from the iterate and its
    carried flows (`fl.F` on the slots under the sparse engine, dense
    under the others), the marginals, permitted sets, Eq. 16 scaling
    and the projected candidate.

    mask_* [S, V] bool: the rows that update (Theorem 2 asynchrony).
    allowed_* : extra permission masks of restricted baselines, in the
    dense [S, V, V+1] / [S, V, V] layout, ANDed into the permitted sets.
    use_blocking=False skips the taint protocol.  `sigma` is σ, a
    float32 scalar on the net's device (the drivers' form) or a number.
    `mg` overrides the marginals the step would solve (the fault layer's
    stale or held broadcasts: the blocked sets then see the same values
    the projection does).  A dense `Phi` comes back dense, a `PhiSparse`
    in slots.  Returns (phi_new, marginals)."""
    check_method(method)
    sparse = method == "sparse"
    native = isinstance(phi, PhiSparse)
    if native and not sparse:
        raise ValueError("PhiSparse iterates require method='sparse'")
    if sparse and nbrs is None:
        raise ValueError("method='sparse' needs nbrs=build_neighbors(adj)")
    if mg is None:
        mg = compute_marginals(net, phi, fl, method, nbrs=nbrs,
                               slot_F=sparse, buckets=buckets)
    S, V = net.S, net.V
    is_dest = _is_dest(net)
    # row layout: edge slots [S, V, Dmax(+1)] when sparse, else dense
    if sparse:
        adj_e = nbrs.out_mask[None]
        phi_d_sp, phi_loc, phi_r_rows = _phi_edge_views(phi, nbrs)
        phi_d_rows = torch.cat([phi_d_sp, phi_loc[..., None]], dim=-1)
    else:
        adj_e = net.adj[None]
        phi_d_rows, phi_r_rows = phi.data, phi.result
    K = adj_e.shape[-1]
    sup_d = (phi_d_rows[..., :-1] > SUPPORT_TOL) & adj_e
    sup_r = (phi_r_rows > SUPPORT_TOL) & adj_e

    if use_blocking:
        if sparse:
            perm_d, perm_r = blocked_sets_sparse(net, phi, mg, nbrs,
                                                 buckets=buckets)
        else:
            perm_d, perm_r = blocked_sets(net, phi, mg)
    else:
        perm_d = torch.cat([adj_e.expand(S, V, K),
                            torch.ones((S, V, 1), dtype=torch.bool,
                                       device=net.device)], dim=-1)
        perm_r = torch.where(is_dest[..., None], False, adj_e)
    if allowed_data is not None:
        if sparse:
            allowed_data = torch.cat(
                [gather_edges(allowed_data, nbrs, fill=False),
                 allowed_data[..., -1:]], dim=-1)
        perm_d = perm_d & allowed_data
    if allowed_result is not None:
        if sparse:
            allowed_result = gather_edges(allowed_result, nbrs, fill=False)
        perm_r = perm_r & allowed_result

    if variant == "sgp":
        if scaling == "paper":
            A_comp, A_max = consts.A_comp, consts.A_max
            A_link_e = (gather_edges(consts.A_link, nbrs) if sparse
                        else consts.A_link)[None]
        else:
            # current-flow curvature (on the slots when sparse), times
            # the safeguard σ
            if not torch.is_tensor(sigma):
                sigma = _f32(sigma, net.device)
            if sparse:
                A_link_e = mask_slots(link_cost_sparse(net, nbrs).d2(fl.F),
                                      nbrs)
            else:
                A_link_e = torch.where(net.adj, net.link_cost.d2(fl.F), 0.0)
            A_link_e = (A_link_e * sigma)[None]
            A_comp = net.comp_cost.d2(fl.G) * sigma
            A_max = None
        if isinstance(kappa, (int, float)) and float(kappa) == 0.0:
            # κ = 0: every κ·n·h·A term is exactly 0, so Eq. 16 is the
            # raw curvature (bitwise A + 0·x == A) and the longest-path
            # recursions are skipped
            diag_r = A_link_e
            diag_d = torch.cat([A_link_e, A_comp[None, :, None]], dim=-1)
        else:
            if A_max is None:
                A_max = torch.maximum(A_link_e.max(), A_comp.max())
            if sparse:
                h_r, h_d = _max_path_len_pair_sparse(sup_r, sup_d, nbrs,
                                                     buckets=buckets)
                hj_r = h_r[:, nbrs.out_nbr]
                hj_d = h_d[:, nbrs.out_nbr]
            else:
                h_r = _max_path_len(sup_r)
                h_d = _max_path_len(sup_d)
                hj_r = h_r[:, None, :]
                hj_d = h_d[:, None, :]
            n_r = perm_r.sum(-1).to(phi_r_rows.dtype)
            n_d = perm_d.sum(-1).to(phi_d_rows.dtype)
            kap = float(kappa)
            diag_r = A_link_e + kap * n_r[..., None] * hj_r * A_max
            diag_d_nbr = A_link_e + kap * n_d[..., None] * hj_d * A_max
            a2 = (net.a ** 2)[:, None]
            diag_d_loc = A_comp[None] + kap * n_d * a2 * (1.0 + h_r) * A_max
            diag_d = torch.cat([diag_d_nbr, diag_d_loc[..., None]], dim=-1)
        Mr = 0.5 * fl.t_result[..., None] * diag_r
        Md = 0.5 * fl.t_data[..., None] * diag_d
        # floor for flat (linear) costs: behaves like conservative GP
        Mr = torch.maximum(Mr, consts.min_scale * fl.t_result[..., None])
        Md = torch.maximum(Md, consts.min_scale * fl.t_data[..., None])
        new_d = _project(phi_d_rows, mg.delta_data, Md, perm_d)
        new_r = _project(phi_r_rows, mg.delta_result, Mr, perm_r)
    elif variant == "gp":
        new_d = gp_rows(phi_d_rows, mg.delta_data, fl.t_data, perm_d, beta)
        new_r = gp_rows(phi_r_rows, mg.delta_result, fl.t_result, perm_r,
                        beta)
    else:
        raise ValueError(f"unknown variant {variant!r}")

    jump_d = _onehot_min(mg.delta_data, perm_d, phi_d_rows.dtype)
    jump_r = _onehot_min(mg.delta_result, perm_r, phi_r_rows.dtype)
    new_d = torch.where((fl.t_data > TRAFFIC_EPS)[..., None], new_d, jump_d)
    new_r = torch.where((fl.t_result > TRAFFIC_EPS)[..., None], new_r, jump_r)
    new_r = torch.where(is_dest[..., None], 0.0, new_r)

    if native or not sparse:
        old_d, old_r = phi_d_rows, phi_r_rows
    else:
        # a dense iterate on the sparse engine comes back dense
        new_d = torch.cat([scatter_edges(new_d[..., :-1], nbrs, V),
                           new_d[..., -1:]], dim=-1)
        new_r = scatter_edges(new_r, nbrs, V)
        old_d, old_r = phi.data, phi.result
    if mask_data is not None:
        new_d = torch.where(mask_data[..., None], new_d, old_d)
    if mask_result is not None:
        new_r = torch.where(mask_result[..., None], new_r, old_r)
    new_phi = (PhiSparse(new_d[..., :-1], new_d[..., -1:], new_r) if native
               else Phi(new_d, new_r))
    return new_phi, mg


def _sgp_step_flows_impl(net: CECNetwork, phi, fl: FlowsCarry,
                         consts: SGPConsts, variant: str = "sgp",
                         beta: float = 1.0, mask_data=None,
                         mask_result=None, allowed_data=None,
                         allowed_result=None, method: str = "dense",
                         use_blocking: bool = True,
                         scaling: str = "adaptive", sigma=1.0,
                         kappa: float = 0.0,
                         nbrs: Optional[Neighbors] = None, buckets=None,
                         with_aux: bool = False, fault_plan=None,
                         fault_state: Optional[FaultState] = None,
                         fault_draws=None,
                         active: Optional[torch.Tensor] = None,
                         mesh=None):
    """One driver iteration: propose from the carried flows, then
    measure the candidate.  Both drivers run exactly this.

    `fault_plan` and `fault_state` (`core.faults`) arm the injectors:
    stale or held broadcasts feed the propose through `mg=`, the
    participation mask folds into the Theorem-2 row masks, and
    corruption poisons the candidate after its flows and cost were
    measured; `fault_draws` are the iteration's draws
    (`faults.draw_faults`), required with a plan.  The return then gains
    the new fault state: (phi_new, carry_new, cost_new, fault_state').

    `active` ([S] bool, a task pool's mask) is folded into the Theorem-2
    row masks, so inactive slots' φ rows are kept bit for bit; their r
    and a are zero, so their flows and cost are exactly zero with no
    mask on the measurement.  None adds no operation at all.  `mesh` (a
    `distributed.TaskMesh`; `net` and φ then hold this rank's task
    shard) all-reduces the candidate's F and G over the ranks, and the
    corruption's task is drawn over the whole task axis.  Returns
    (phi_new, carry_new, cost_new[, marginals of `phi` if with_aux])."""
    faulted = fault_plan is not None and fault_state is not None
    mg_in = None
    if faulted:
        mg_in, pmask, fs_mid = _faults.fault_step_begin(
            net, phi, fl, fault_state, fault_plan, fault_draws, method,
            nbrs, buckets)
        if pmask is not None:
            mask_data = pmask if mask_data is None else mask_data & pmask
            mask_result = (pmask if mask_result is None
                           else mask_result & pmask)
    if active is not None:
        am = active[:, None]                            # [S, 1] -> [S, V]
        mask_data = am if mask_data is None else mask_data & am
        mask_result = am if mask_result is None else mask_result & am
    phi_new, mg = _sgp_propose_impl(
        net, phi, fl, consts, variant=variant, beta=beta,
        mask_data=mask_data, mask_result=mask_result,
        allowed_data=allowed_data, allowed_result=allowed_result,
        method=method, use_blocking=use_blocking, scaling=scaling,
        sigma=sigma, kappa=kappa, nbrs=nbrs, buckets=buckets, mg=mg_in)
    carry_new, cost_new = flows_carry_and_cost(net, phi_new, method,
                                               nbrs=nbrs, buckets=buckets,
                                               mesh=mesh)
    if faulted:
        phi_new, fs_new = _faults.fault_step_end(
            net, phi_new, fault_draws, fault_plan, fs_mid, nbrs=nbrs,
            mesh=mesh)
        return phi_new, carry_new, cost_new, fs_new
    if with_aux:
        return phi_new, carry_new, cost_new, mg
    return phi_new, carry_new, cost_new


def sgp_step(net: CECNetwork, phi, consts: SGPConsts, variant: str = "sgp",
             beta: float = 1.0, mask_data=None, mask_result=None,
             allowed_data=None, allowed_result=None, method: str = "dense",
             use_blocking: bool = True, scaling: str = "adaptive",
             sigma=1.0, kappa: float = 1.0,
             nbrs: Optional[Neighbors] = None, buckets=None):
    """One synchronized iteration of Algorithm 1 from φ alone, the
    reference's public step: φ's flows (Eq. 1-2, F dense [V, V]) are
    solved first, then the marginals, blocked sets, Eq. 16 scaling and
    projection.  The options are `_sgp_propose_impl`'s (κ defaults to 1,
    as the reference's).  Returns (phi_new, {"cost", "flows",
    "marginals"}) with the cost, `Flows` and marginals of `phi`."""
    fl = compute_flows(net, phi, method, nbrs=nbrs, buckets=buckets)
    # the step reads F on the slots under the sparse engine: the dense
    # F gathered there, value for value
    F = gather_edges(fl.F, nbrs) if method == "sparse" else fl.F
    phi_new, mg = _sgp_propose_impl(
        net, phi, FlowsCarry(fl.t_data, fl.t_result, F, fl.G), consts,
        variant=variant, beta=beta, mask_data=mask_data,
        mask_result=mask_result, allowed_data=allowed_data,
        allowed_result=allowed_result, method=method,
        use_blocking=use_blocking, scaling=scaling, sigma=sigma,
        kappa=kappa, nbrs=nbrs, buckets=buckets)
    return phi_new, {"cost": cost_of_flows(net, fl), "flows": fl,
                     "marginals": mg}


# ------------------------------------------------------------------ driver
def accept_step(new_cost: float, prev_cost: float, sigma: float,
                scaling: str = "adaptive", variant: str = "sgp"):
    """Accept/reject rule and σ safeguard, in float32 like the reference.

    A non-finite cost is never accepted; under adaptive SGP an uphill
    cost is rejected too.  A rejection quadruples σ (stopping past
    1e12), an acceptance decays it toward 1.  Returns (accepted, sigma,
    stopped)."""
    new32, prev32 = np.float32(new_cost), np.float32(prev_cost)
    accepted = bool(np.isfinite(new32)) and not (
        scaling == "adaptive" and variant == "sgp"
        and new32 > prev32 * np.float32(1.0 + 1e-12))
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
    exactly where the previous chunk stopped.  `phi` is the iterate in
    the engine's layout (`PhiSparse` under method="sparse", else `Phi`);
    `it` is the global iteration count (it sets the paper-scaling
    refresh cadence across chunks); `rng` is the torch.Generator, on the
    network's device, that draws the Theorem-2 row masks; `active` is a
    task pool's [S] bool mask (None: every slot live, and no mask
    operation in the step); `graph_stats` is what the fused driver's
    last chunk measured of its CUDA graph (None on the CPU).  The fault
    plan and state (`core.faults`) and the guard policy and state
    (`core.guards`) ride the fused driver's carry; `guard_events` are
    the trips so far.  `mesh` (a `distributed.TaskMesh`) makes the state
    a rank's task shard: every step all-reduces F and G over it."""
    phi: object                     # Phi | PhiSparse
    consts: SGPConsts
    nbrs: Optional[Neighbors]       # sparse engine only
    method: str
    costs: list
    min_scale: float = 0.05
    sigma: float = 1.0
    n_rejected: int = 0
    it: int = 0                     # iterations executed so far
    rng: Optional[torch.Generator] = None
    stopped: bool = False           # σ blow-up / tol early exit
    flows: Optional[FlowsCarry] = None   # flows of `phi`
    buckets: object = None          # NeighborBuckets (bucketed mode)
    graph_stats: Optional[dict] = None
    fault_plan: object = None       # faults.FaultPlan
    fault_state: Optional[FaultState] = None
    guard_cfg: object = None        # guards.GuardConfig
    guard_state: object = None      # guards.GuardState
    guard_events: list = dataclasses.field(default_factory=list)
    active: Optional[torch.Tensor] = None   # a task pool's [S] bool mask
    mesh: object = None             # distributed.TaskMesh (a task shard)


def init_run_state(net: CECNetwork, phi0, min_scale: float = 0.05,
                   method: str = "dense",
                   rng: Optional[torch.Generator] = None,
                   nbrs: Optional[Neighbors] = None, bucketed: bool = False,
                   buckets=None, fault_plan=None,
                   fault_rng: Optional[torch.Generator] = None,
                   guards=None,
                   active: Optional[torch.Tensor] = None,
                   mesh=None) -> RunState:
    """Under method="sparse", build (or accept) the neighbour lists and,
    with bucketed=True, the degree buckets, and convert a dense φ⁰ to
    slots; the dense and broadcast engines iterate the dense `Phi`.
    Evaluate φ⁰'s flows and cost T⁰ (one solve, both carried) and the
    Eq. 16 constants.  `fault_plan` (`faults.FaultPlan`) arms the fault
    injectors, drawing from `fault_rng` (a torch.Generator on the net's
    device, apart from the Theorem-2 `rng`; default seed 0); `guards`
    (`guards.GuardConfig`) arms the sentinels and rollback, anchored at
    φ⁰.  Either sends `run_chunk` to the fused driver.  `active` ([S]
    bool on the net's device) threads a task pool's mask through every
    step (`_sgp_step_flows_impl`); `mesh` shards the state over tasks
    (`core.distributed`: `net` and φ⁰ hold this rank's tasks)."""
    check_method(method)
    if rng is not None and rng.device.type != net.device.type:
        raise ValueError(f"the driver's generator lies on {rng.device}, "
                         f"the network on {net.device}")
    if method == "sparse":
        nbrs = build_neighbors(net.adj) if nbrs is None else nbrs
        if bucketed and buckets is None:
            buckets = build_buckets(net.adj)
        if not isinstance(phi0, PhiSparse):
            phi0 = phi_to_sparse(phi0, nbrs)   # boundary: iterate in slots
    else:
        nbrs = buckets = None
    fl0, T0 = flows_carry_and_cost(net, phi0, method, nbrs=nbrs,
                                   buckets=buckets, mesh=mesh)
    fault_state = guard_state = None
    if fault_plan is not None:
        fault_state = init_fault_state(net, phi0, fl0, fault_plan,
                                       rng=fault_rng, method=method,
                                       nbrs=nbrs, buckets=buckets)
    if guards is not None:
        from .guards import init_guard_state   # guards imports sgp
        guard_state = init_guard_state(phi0, fl0, T0, guards)
    return RunState(phi=phi0, consts=make_consts(net, T0, min_scale),
                    nbrs=nbrs, method=method, costs=[float(T0)],
                    min_scale=min_scale, rng=rng, flows=fl0,
                    buckets=buckets, fault_plan=fault_plan,
                    fault_state=fault_state, guard_cfg=guards,
                    guard_state=guard_state, active=active, mesh=mesh)


def _async_masks(gen: torch.Generator, net: CECNetwork, async_frac: float):
    """The Theorem-2 row masks of one iteration: each (task, node) row
    updates with probability 1 − async_frac."""
    keep = 1.0 - async_frac
    return tuple(torch.rand((net.S, net.V), generator=gen,
                            device=net.device) < keep for _ in range(2))


def _refreshed_consts(net: CECNetwork, consts: SGPConsts, T: torch.Tensor,
                      stopped: Optional[torch.Tensor] = None) -> SGPConsts:
    """The paper-scaling refresh: the Eq. 16 sups at the cost T (a float32
    scalar on the device); a `stopped` carry keeps the old ones."""
    fresh = _curvature_sups(net, T)
    if stopped is not None:
        old = (consts.A_link, consts.A_comp, consts.A_max)
        fresh = [torch.where(stopped, o, n) for o, n in zip(old, fresh)]
    return SGPConsts(*fresh, consts.min_scale)


def _accept_update_impl(phi_new, fl_new, cost_new, phi, fl, sigma, prev,
                        n_costs, n_rej, stopped, tol, adaptive: bool):
    """`accept_step` and `_tol_converged` as branchless selects on the
    device: one iteration's carry update for the fused driver.  The φ and
    flows selects write into `phi` and `fl`.

    Every operation is one correctly rounded float32 elementwise op, as
    in `accept_step`, with its constants as float32 scalars; `stopped`
    freezes the whole carry, which is the host loop's `break`.  Returns
    the updated scalars of the carry (sigma, prev, n_costs, n_rej,
    stopped) and (take, live): whether this iteration accepted its
    candidate / was executed at all."""
    dev = cost_new.device
    live = ~stopped
    acc = torch.isfinite(cost_new)
    if adaptive:
        acc = acc & ~(cost_new > prev * _f32(1.0 + 1e-12, dev))
    take = live & acc
    for new, old in zip(_fields(phi_new) + _fields(fl_new),
                        _fields(phi) + _fields(fl)):
        torch.where(take, new, old, out=old)
    sigma_next = torch.where(
        acc, torch.maximum(sigma * _f32(SIGMA_DECAY, dev), _f32(1.0, dev)),
        sigma * _f32(4.0, dev))
    sigma = torch.where(live, sigma_next, sigma)
    stop_sigma = live & ~acc & (sigma > _f32(1e12, dev))
    n_costs = n_costs + take.to(torch.int32)
    tol_hit = (tol > _f32(0.0, dev)) & (
        torch.abs(prev - cost_new)
        <= tol * torch.maximum(cost_new, _f32(1e-12, dev)))
    stop_tol = take & (n_costs > 4) & tol_hit
    prev = torch.where(take, cost_new, prev)
    n_rej = n_rej + (live & ~acc).to(torch.int32)
    stopped = stopped | stop_sigma | stop_tol
    return sigma, prev, n_costs, n_rej, stopped, take, live


def _entry_flows(net: CECNetwork, state: RunState) -> FlowsCarry:
    """The chunk-entry flows: the state's carry of its iterate, solved
    again only if a caller dropped it (after editing `state.phi`)."""
    if state.flows is not None:
        return state.flows
    fl, _ = flows_carry_and_cost(net, state.phi, state.method,
                                 nbrs=state.nbrs, buckets=state.buckets,
                                 mesh=state.mesh)
    return fl


def run_chunk(net: CECNetwork, state: RunState, n_iters: int,
              variant: str = "sgp", beta: float = 1.0,
              allowed_data=None, allowed_result=None,
              async_frac: float = 0.0, tol: float = 0.0, callback=None,
              use_blocking: bool = True, refresh_every: int = 20,
              scaling: str = "adaptive", kappa: float = 0.0,
              driver: Optional[str] = None) -> RunState:
    """Advance the driver `n_iters` iterations, updating `state` in place
    (and returning it).  A stopped state (tol exit, σ blow-up) stays
    stopped: further chunks are no-ops.

    driver: "host" syncs once an iteration (the candidate's cost) and
    decides on the host; "fused" decides on the device and reads the
    chunk's costs back once (`FusedStream`); None picks "fused" unless a
    `callback(it, phi, aux, accepted)` needs the host loop.  Both walk
    the same costs, σ, generator draws and φ bit for bit.  A state with
    a fault plan or guards runs the fused driver (their carries live
    there) and refuses a callback.  The tol exit fires only after an
    accepted step."""
    if driver is None:
        driver = "host" if callback is not None else "fused"
    if driver not in ("host", "fused"):
        raise ValueError(f"unknown driver {driver!r}")
    if variant not in ("sgp", "gp"):
        raise ValueError(f"unknown variant {variant!r}")
    if scaling not in ("adaptive", "paper"):
        raise ValueError(f"unknown scaling {scaling!r}")
    if async_frac > 0.0 and state.rng is None:
        raise ValueError("async_frac > 0 needs a driver generator: pass "
                         "rng=torch.Generator(device) to init_run_state "
                         "or run")
    if state.fault_plan is not None or state.guard_cfg is not None:
        if callback is not None:
            raise ValueError("fault injection and guards run the fused "
                             "driver; per-iteration callbacks need a "
                             "fault-free host loop")
        driver = "fused"
    if driver == "fused" and callback is not None:
        raise ValueError("driver='fused' runs the whole chunk on the "
                         "device; per-iteration callbacks need "
                         "driver='host'")
    if state.stopped or n_iters <= 0:
        return state
    if scaling == "paper":
        kappa = 1.0   # Eq. 16 verbatim
    fl = _entry_flows(net, state)
    opts = dict(variant=variant, beta=beta, allowed_data=allowed_data,
                allowed_result=allowed_result, use_blocking=use_blocking,
                scaling=scaling, kappa=kappa)
    if driver == "fused":
        stream = FusedStream(net, state, fl, async_frac=async_frac, tol=tol,
                             refresh_every=refresh_every, **opts)
        stream.advance(n_iters)
        stream.finish()
        return state
    dev = net.device
    phi, consts, costs = state.phi, state.consts, state.costs
    sigma, n_rejected, done = state.sigma, state.n_rejected, state.it
    for it in range(state.it, state.it + n_iters):
        done = it + 1
        if scaling == "paper" and refresh_every and it > 0 \
                and it % refresh_every == 0:
            consts = _refreshed_consts(net, consts, _f32(costs[-1], dev))
        mask_d = mask_r = None
        if async_frac > 0.0:
            mask_d, mask_r = _async_masks(state.rng, net, async_frac)
        out = _sgp_step_flows_impl(
            net, phi, fl, consts, mask_data=mask_d, mask_result=mask_r,
            sigma=_f32(sigma, dev), method=state.method, nbrs=state.nbrs,
            buckets=state.buckets, active=state.active, mesh=state.mesh,
            with_aux=callback is not None, **opts)
        phi_new, fl_new, cost_new = out[:3]
        new_cost = float(cost_new)   # the host driver's one sync
        accepted, sigma, stop = accept_step(new_cost, costs[-1], sigma,
                                            scaling, variant)
        if callback is not None:
            # the iterate the step started FROM: its cost is the last
            # accepted one, its flows the driver's carry
            aux = {"cost": _f32(costs[-1], dev), "flows": fl,
                   "marginals": out[3]}
        if not accepted:
            n_rejected += 1
            if stop:
                state.stopped = True
                break
        else:
            phi, fl = phi_new, fl_new
            costs.append(new_cost)
        if callback is not None:
            callback(it, phi, aux, accepted)
        if accepted and _tol_converged(costs, tol):
            state.stopped = True
            break
    state.phi, state.consts, state.flows = phi, consts, fl
    state.sigma, state.n_rejected, state.it = sigma, n_rejected, done
    return state


# the network fields a same-graph churn event may change (the fused
# stream owns them, and the compute costs)
_CHURN_FIELDS = ("r", "dest", "a", "w", "task_type")
# one side stream and one graph memory pool a card, shared by every fused
# stream's warm-up and capture: each replay's temporaries live in the
# pool and every value that outlives a replay in the stream's own
# buffers, so graphs replayed one after another on one stream can share
# it, and a replay's succession of graphs (one a segment of the event
# loop) reuses one pool's memory instead of caching a pool a graph.  The
# last graph captured is kept (`_LAST_GRAPHS`): a pool whose graphs are
# all gone is released, and its handle cannot be captured into again.
_SIDE_STREAMS: dict = {}
_GRAPH_POOLS: dict = {}
_LAST_GRAPHS: dict = {}


def _device_key(dev: torch.device) -> int:
    return torch.cuda.current_device() if dev.index is None else dev.index


def _side_stream(dev: torch.device):
    key = _device_key(dev)
    if key not in _SIDE_STREAMS:
        _SIDE_STREAMS[key] = torch.cuda.Stream(device=key)
        _GRAPH_POOLS[key] = torch.cuda.graph_pool_handle()
    return _SIDE_STREAMS[key], _GRAPH_POOLS[key]


def _render_guard_events(rows, it0: int) -> list:
    """The `GuardEvent`s of a segment's history rows (cost, take, live,
    code, rolled, restored cost), numbered from `it0`."""
    from .guards import SENTINEL_NAMES, GuardEvent
    return [GuardEvent(it=it0 + i, sentinel=SENTINEL_NAMES[int(code)],
                       action="rollback" if rolled else "stop", cost=cost,
                       restored_cost=ck if rolled else None)
            for i, (cost, _, live, code, rolled, ck) in enumerate(rows)
            if live and code > 0]


class _Graphed:
    """Runs `fn`, one driver iteration on buffers it owns, once a
    dispatch.  On the CPU it runs eagerly.  On the card the first call
    runs eagerly on a side stream (it builds the kernels and their
    cluster plans), the second is captured into a `torch.cuda.CUDAGraph`
    and that graph is replayed from then on; the kernels' launch
    counters tick once a replay (`kernels.ops.add_launches`).  If the
    capture fails the run raises; there is no second path.  `stats`
    records the warm-up, the captures and the replays."""

    def __init__(self, fn, device: torch.device):
        self.fn, self.device = fn, device
        self.graph = None
        self.dispatched = 0
        self.per_replay: dict = {}
        self.stats = {"graph": device.type == "cuda", "warmup_s": None,
                      "capture_s": None, "captures": 0, "pool_bytes": None,
                      "replays": 0, "launches_per_replay": None}

    def reset(self) -> None:
        """The next call captures a new graph (the iteration changed)."""
        self.graph, self.dispatched = None, 0

    def __call__(self) -> None:
        if self.device.type != "cuda":
            self.fn()
        elif self.dispatched == 0:
            t0 = time.perf_counter()
            side, _ = _side_stream(self.device)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.fn()
            torch.cuda.current_stream().wait_stream(side)
            self.stats["warmup_s"] = time.perf_counter() - t0
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            kernel_ops.add_launches(self.per_replay)
            self.stats["replays"] += 1
        self.dispatched += 1

    def _capture(self) -> None:
        t0 = time.perf_counter()
        reserved = torch.cuda.memory_reserved()
        before = kernel_ops.launches()
        graph = torch.cuda.CUDAGraph()
        side, pool = _side_stream(self.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool)
            try:
                self.fn()
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        after = kernel_ops.launches()
        # capturing launches nothing: the counts ticked are one replay's
        self.per_replay = {k: after[k] - before[k] for k in after
                           if after[k] != before[k]}
        kernel_ops.add_launches(self.per_replay, -1)
        self.graph = _LAST_GRAPHS[_device_key(self.device)] = graph
        self.stats["captures"] += 1
        self.stats.update(
            capture_s=(self.stats["capture_s"] or 0.0)
            + time.perf_counter() - t0,
            pool_bytes=torch.cuda.memory_reserved() - reserved,
            launches_per_replay=dict(self.per_replay))


def _copy_into(dst, src) -> None:
    """A dataclass of tensors (or a tuple of them) copied into another's
    buffers, field by field (a field that is its own source is left)."""
    dsts = dst if isinstance(dst, tuple) else _fields(dst)
    srcs = src if isinstance(src, tuple) else _fields(src)
    for d, s in zip(dsts, srcs):
        if s is not d:
            d.copy_(s)


def _fault_tensors(fs: FaultState) -> tuple:
    """The device tensors of a fault carry: ring, hold, count."""
    return tuple(fs.ring or ()) + tuple(fs.held or ()) + (fs.n_corrupt,)


# the guard carry's fields the update returns anew (the ring is written
# in place)
_GUARD_SCALARS = ("ptr", "window", "wptr", "retries", "n_trips")


class FusedStream:
    """The fused driver: the accept/reject loop with no host read inside.

    The carry (φ, flows, consts, σ, the last accepted cost, counts,
    `stopped`, and the fault and guard carries) lives in device tensors
    that each iteration updates in place, as do the network fields a
    same-graph event changes (r, dest, a, w, task_type, the compute
    costs) and a task pool's `active` mask: the stream owns copies of
    all of them.  Each iteration's candidate cost and take/live flags
    (and, guarded, its sentinel code, rollback flag and restored cost)
    land in a device history that `finish` reads back once.  A stopped
    carry keeps dispatching frozen no-ops whose outputs are discarded;
    it freezes the fault carry too.

    On the card the iteration is captured once into a CUDA graph and
    replayed (`_Graphed`).  The paper-scaling refresh, the Theorem-2
    masks, the fault draws (`faults.draw_faults`), the guards'
    checkpoint flag and `rebaseline` are eager ops between replays,
    writing the buffers the graph reads; each generator's state before
    each draw is kept, so a stopped carry rewinds both generators past
    the draws of its frozen iterations.  `stats` records the captures.

    `rebaseline` folds a same-graph churn event into the carry as the
    replay engine's event loop builds a fresh `RunState` (the same
    repair, flows, T⁰ and constants, σ and the counts reset, the fault
    state re-initialised and the guard carry re-anchored), with no host
    read, so one stream carries a whole window of events and stays bit
    for bit the event loop (`core.replay`)."""

    def __init__(self, net: CECNetwork, state: RunState, fl=None, *,
                 variant: str = "sgp", beta: float = 1.0,
                 allowed_data=None, allowed_result=None,
                 async_frac: float = 0.0, tol: float = 0.0,
                 use_blocking: bool = True, refresh_every: int = 20,
                 scaling: str = "adaptive", kappa: float = 0.0):
        if scaling == "paper":
            kappa = 1.0
        if async_frac > 0.0 and state.rng is None:
            raise ValueError("async_frac > 0 needs a driver generator")
        self.state = state
        self._o = dict(variant=variant, beta=beta, allowed_data=allowed_data,
                       allowed_result=allowed_result,
                       use_blocking=use_blocking, scaling=scaling,
                       kappa=kappa, method=state.method)
        self._adaptive = scaling == "adaptive" and variant == "sgp"
        self._refresh = refresh_every if scaling == "paper" else 0
        self._async = async_frac
        dev = net.device
        fl = fl if fl is not None else _entry_flows(net, state)

        def own(x):
            return type(x)(*(t.clone() for t in _fields(x)))

        # the buffers the graph reads, owned by the stream
        self.net = dataclasses.replace(
            net, **{k: getattr(net, k).clone() for k in _CHURN_FIELDS},
            comp_cost=dataclasses.replace(
                net.comp_cost, params=net.comp_cost.params.clone()))
        self._phi, self._fl = own(state.phi), own(fl)
        self._consts = own(state.consts)
        self._active = (None if state.active is None
                        else state.active.clone())
        self._rng = state.rng
        self._sigma = _f32(state.sigma, dev)
        self._prev = _f32(state.costs[-1], dev)
        self._n_costs = torch.full((), len(state.costs), dtype=torch.int32,
                                   device=dev)
        self._n_rej = torch.zeros((), dtype=torch.int32, device=dev)
        self._stopped = torch.full((), bool(state.stopped), dtype=torch.bool,
                                   device=dev)
        self._tol = _f32(tol, dev)
        self._masks = None
        if async_frac > 0.0:
            self._masks = tuple(torch.ones((net.S, net.V), dtype=torch.bool,
                                           device=dev) for _ in range(2))
        # the fault carry and the buffers of an iteration's draws
        self._plan = self._fs = self._draws = None
        if state.fault_plan is not None and state.fault_state is not None:
            fs = state.fault_state
            self._plan = state.fault_plan
            self._fs = FaultState(
                gen=fs.gen,
                ring=(None if fs.ring is None
                      else tuple(t.clone() for t in fs.ring)),
                held=(None if fs.held is None
                      else tuple(t.clone() for t in fs.held)),
                n_corrupt=fs.n_corrupt.clone())
            self._draws = _faults.draw_buffers(net.V, dev)
        self._fgen_states: list = []  # the fault generator before each draw
        # the guard carry and the checkpoint flag of the next replay
        self._gs = self._do_ckpt = None
        if state.guard_cfg is not None and state.guard_state is not None:
            gs = state.guard_state
            self._gs = dataclasses.replace(
                gs, ckpt_phi=own(gs.ckpt_phi), ckpt_fl=own(gs.ckpt_fl),
                **{f: getattr(gs, f).clone() for f in
                   ("ckpt_cost", "ckpt_sigma", "valid") + _GUARD_SCALARS})
            self._do_ckpt = (torch.zeros((), dtype=torch.bool, device=dev)
                             if state.guard_cfg.checkpoint_every else False)
        self._rec = torch.zeros(3 if self._gs is None else 6,
                                dtype=torch.float32, device=dev)
        self._hist: list = []
        self._n_rows = 0              # iterations dispatched so far
        self._gen_states: list = []   # the generator before each draw
        self._it = state.it           # the open segment's iteration count
        self._seg_it0 = state.it      # the count the open segment began at
        self._markers: list = []      # closed segments' boundary scalars
        self._runner = _Graphed(self._iterate, dev)
        self.stats = self._runner.stats
        self._finished = False

    def _iterate(self):
        """One iteration on the carry, in place."""
        md, mr = self._masks if self._masks is not None else (None, None)
        st = self.state
        out = _sgp_step_flows_impl(
            self.net, self._phi, self._fl, self._consts, mask_data=md,
            mask_result=mr, sigma=self._sigma, nbrs=st.nbrs,
            buckets=st.buckets, active=self._active, fault_plan=self._plan,
            fault_state=self._fs, fault_draws=self._draws, mesh=st.mesh,
            **self._o)
        phi_new, fl_new, cost_new = out[:3]
        if self._fs is not None:
            # a stopped carry freezes the fault carry too
            for d, s in zip(_fault_tensors(self._fs),
                            _fault_tensors(out[3])):
                if s is not d:
                    torch.where(self._stopped, d, s, out=d)
        args = (phi_new, fl_new, cost_new, self._phi, self._fl, self._sigma,
                self._prev, self._n_costs, self._n_rej, self._stopped,
                self._tol)
        if self._gs is not None:
            from .guards import _guarded_update_impl
            *scalars, take, live, gs, code, rolled, ck_cost = \
                _guarded_update_impl(*args, self._gs, st.nbrs,
                                     adaptive=self._adaptive,
                                     cfg=st.guard_cfg,
                                     do_ckpt=self._do_ckpt, mesh=st.mesh)
            for f in _GUARD_SCALARS:
                getattr(self._gs, f).copy_(getattr(gs, f))
            rec = (cost_new, take, live, code, rolled, ck_cost)
        else:
            *scalars, take, live = _accept_update_impl(*args,
                                                       self._adaptive)
            rec = (cost_new, take, live)
        for d, s in zip((self._sigma, self._prev, self._n_costs,
                         self._n_rej, self._stopped), scalars):
            d.copy_(s)
        self._rec.copy_(torch.stack([x.float() for x in rec]))

    def advance(self, n_iters: int) -> "FusedStream":
        """Dispatch `n_iters` iterations; the host never waits on the
        device."""
        _advance_streams([self], n_iters, self._runner, self._rec[None])
        return self

    def _prepare(self, it: int) -> None:
        """The eager work before iteration `it`'s dispatch (the
        paper-scaling refresh, the Theorem-2 masks, the fault draws, the
        checkpoint flag), written into the buffers the graph reads."""
        net = self.net
        if self._refresh and it > 0 and it % self._refresh == 0:
            fresh = _refreshed_consts(net, self._consts, self._prev,
                                      self._stopped)
            _copy_into(self._consts, fresh)
        if self._masks is not None:
            self._gen_states.append(self._rng.get_state())
            _copy_into(self._masks,
                       _async_masks(self._rng, net, self._async))
        if self._fs is not None:
            self._fgen_states.append(self._fs.gen.get_state())
            _copy_into(self._draws, _faults.draw_faults(
                self._fs.gen, self._plan, net.S, net.V))
        if self._do_ckpt is not None and self._do_ckpt is not False:
            self._do_ckpt.fill_(
                it % self.state.guard_cfg.checkpoint_every == 0)

    def rebaseline(self, net_new: CECNetwork, repair=None, *, fault_rng=None,
                   rng=None, active=None) -> "FusedStream":
        """Fold one SAME-GRAPH churn event into the carry with no host
        read: close the open segment (its boundary scalars are cloned,
        since the carry's are overwritten in place, and read in
        `finish`) and open the next one as the event loop's fresh
        `RunState` would.

        `repair` maps the current φ to the repaired one (a routing
        event's `refeasibilize_sparse_samegraph`, a task event's slot
        repairs; device ops only); a rate event passes None.  The
        churned network's r, dest, a, w, task_type and compute costs are
        copied into the buffers the captured graph reads, as are the
        fresh φ, flows, T⁰ and constants; σ = 1, the counts reset.  A
        fault plan's state is re-initialised on the repaired φ, drawing
        from `fault_rng` (default seed 0), and the guard carry is
        re-anchored at T⁰.  `net_new` must have the stream's adjacency
        and link costs (topology events break the stream).  `rng` is the
        new segment's Theorem-2 generator; `active` a task pool's
        updated mask (the first mask of a stream that had none captures
        a new graph)."""
        if self._finished:
            raise RuntimeError("stream already finished")
        if net_new.link_cost.params is not self.net.link_cost.params \
                or net_new.adj.shape != self.net.adj.shape \
                or net_new.S != self.net.S:
            raise ValueError("a rebaseline keeps the graph, the link "
                             "costs and S: a topology event breaks the "
                             "stream")
        st = self.state
        self._markers.append(dict(end=self._n_rows, it0=self._seg_it0,
                                  prev=self._prev.clone(),
                                  n_rej=self._n_rej.clone()))
        phi = self._phi if repair is None else repair(self._phi)
        fl, T0 = flows_carry_and_cost(net_new, phi, st.method, nbrs=st.nbrs,
                                      buckets=st.buckets, mesh=st.mesh)
        consts = make_consts(net_new, T0, st.min_scale)
        self._markers[-1]["T0"] = T0
        if self._fs is not None:
            fs = init_fault_state(net_new, phi, fl, self._plan, rng=fault_rng,
                                  method=st.method, nbrs=st.nbrs,
                                  buckets=st.buckets)
            _copy_into(_fault_tensors(self._fs), _fault_tensors(fs))
            self._fs = dataclasses.replace(self._fs, gen=fs.gen)
            self._fgen_states = []
        if self._gs is not None:
            from .guards import init_guard_state
            gs = init_guard_state(phi, fl, T0, st.guard_cfg)
            _copy_into(self._gs.ckpt_phi, gs.ckpt_phi)
            _copy_into(self._gs.ckpt_fl, gs.ckpt_fl)
            for f in ("ckpt_cost", "ckpt_sigma", "valid") + _GUARD_SCALARS:
                getattr(self._gs, f).copy_(getattr(gs, f))
        for k in _CHURN_FIELDS:
            getattr(self.net, k).copy_(getattr(net_new, k))
        self.net.comp_cost.params.copy_(net_new.comp_cost.params)
        for own, new in ((self._phi, phi), (self._fl, fl),
                         (self._consts, consts)):
            if new is not own:
                _copy_into(own, new)
        if active is not None:
            st.active = active
            if self._active is None:
                # the step gains the mask's operations: a new graph
                self._active = active.clone()
                self._runner.reset()
            else:
                self._active.copy_(active)
        self._sigma.fill_(1.0)
        self._prev.copy_(T0)
        self._n_costs.fill_(1)
        self._n_rej.zero_()
        self._stopped.fill_(False)
        self._it = self._seg_it0 = 0
        self._gen_states = []
        if rng is not None:
            self._rng = rng
        return self

    def finish(self) -> list:
        """The stream's single device-to-host read.

        With no rebaselines it leaves `state` where the host driver
        would have (costs extended, `it` and `n_rejected` advanced, the
        generators too, guard trips appended to `guard_events`) and
        returns [].  With rebaselines it returns one dict per segment
        (``accepted`` costs, ``executed`` iterations, ``n_rejected``,
        ``guard_events``, and for each closed segment its event's
        ``cost_before`` and ``cost_after``), the open one last, and
        leaves `state` as that segment's warm `RunState`: what the event
        loop's fresh state would be after the same iterations.  Guard
        events are numbered from each segment's first iteration, as the
        event loop's fresh states count."""
        return _finish_streams([self])[0]

    def _pack(self) -> torch.Tensor:
        """Close the stream and gather what `finish` reads back, as one
        float32 vector: the history rows, each closed segment's boundary
        (cost before, rejections, T⁰), then σ, the open segment's
        rejections and `stopped`."""
        if self._finished:
            raise RuntimeError("stream already finished")
        self._finished = True
        self._runner.graph = None
        dev = self.net.device
        hist = (torch.cat(self._hist) if self._hist else
                torch.empty((0, self._rec.shape[0]), device=dev))
        parts = [hist.reshape(-1)]
        if self._markers:
            parts.append(torch.stack([
                torch.stack([m["prev"].float(), m["n_rej"].float(),
                             m["T0"].float()])
                for m in self._markers]).reshape(-1))
        parts.append(torch.stack([self._sigma.float(), self._n_rej.float(),
                                  self._stopped.float()]))
        return torch.cat(parts)

    def _unpack(self, packed: list) -> list:
        """`finish`'s bookkeeping on the values `_pack` gathered."""
        st = self.state
        st.graph_stats = dict(self.stats) if self.stats["graph"] else None
        n, w, m = self._n_rows, self._rec.shape[0], len(self._markers)
        rows = [packed[w * i:w * i + w] for i in range(n)]
        sigma, n_rej, stopped = packed[-3:]
        if not m:
            n_live = sum(1 for r in rows if r[2])
            st.costs.extend(r[0] for r in rows if r[2] and r[1])
            st.sigma, st.stopped = sigma, bool(stopped)
            st.n_rejected += int(n_rej)
            st.it += n_live
            self._finish_state(n_live)
            if self._gs is not None:
                st.guard_events.extend(_render_guard_events(rows,
                                                            self._seg_it0))
            return []
        marks = [packed[w * n + 3 * k:w * n + 3 * k + 3] for k in range(m)]
        bounds = [0] + [mk["end"] for mk in self._markers] + [n]
        it0s = [mk["it0"] for mk in self._markers] + [self._seg_it0]
        segs = []
        for k in range(m + 1):
            seg_rows = rows[bounds[k]:bounds[k + 1]]
            seg = {"accepted": [r[0] for r in seg_rows if r[2] and r[1]],
                   "executed": sum(1 for r in seg_rows if r[2]),
                   "guard_events": (_render_guard_events(seg_rows, it0s[k])
                                    if self._gs is not None else [])}
            if k < m:
                seg.update(cost_before=marks[k][0],
                           n_rejected=int(marks[k][1]),
                           cost_after=marks[k][2])
            else:
                seg["n_rejected"] = int(n_rej)
            segs.append(seg)
        last = segs[-1]
        st.costs = [marks[-1][2]] + list(last["accepted"])
        st.sigma, st.n_rejected = sigma, int(n_rej)
        st.it, st.stopped = last["executed"], bool(stopped)
        st.rng = self._rng
        st.guard_events = list(last["guard_events"])
        self._finish_state(last["executed"])
        return segs

    def _finish_state(self, n_live: int) -> None:
        """The carry back into `state`.  A stopped carry's frozen
        iterations drew masks and faults the host loop never drew:
        rewind the open segment's generators past them."""
        st = self.state
        if n_live < len(self._gen_states):
            self._rng.set_state(self._gen_states[n_live])
        if n_live < len(self._fgen_states):
            self._fs.gen.set_state(self._fgen_states[n_live])
        st.phi, st.flows, st.consts = self._phi, self._fl, self._consts
        if self._fs is not None:
            st.fault_state = self._fs
        if self._gs is not None:
            st.guard_state = self._gs


def _advance_streams(streams, n_iters: int, runner, rec) -> None:
    """Dispatch `n_iters` iterations of fused streams on one device, one
    call of `runner` an iteration: it runs every stream's `_iterate` and
    leaves their history rows in `rec` [len(streams), w], copied into
    the streams' histories."""
    if any(s._finished for s in streams):
        raise RuntimeError("stream already finished")
    if n_iters <= 0:
        return
    hist = torch.empty((n_iters,) + tuple(rec.shape), dtype=torch.float32,
                       device=rec.device)
    for i in range(n_iters):
        for s in streams:
            s._prepare(s._it + i)
        runner()
        hist[i].copy_(rec)
    for b, s in enumerate(streams):
        s._hist.append(hist[:, b])
        s._n_rows += n_iters
        s._it += n_iters


def _finish_streams(streams) -> list:
    """`FusedStream.finish` for fused streams on one device with a single
    device-to-host read between them.  Returns each stream's segments."""
    packs = [s._pack() for s in streams]
    host = torch.cat(packs).cpu().tolist()
    out, o = [], 0
    for s, p in zip(streams, packs):
        out.append(s._unpack(host[o:o + p.numel()]))
        o += p.numel()
    return out


def run_opt_keys(fn=None) -> frozenset:
    """The keyword options a caller may forward to a driver as a
    `run_opts` dict: `run_chunk`'s by default, or any driver `fn`'s,
    less the positional inputs wrappers own."""
    fn = run_chunk if fn is None else fn
    return frozenset(inspect.signature(fn).parameters) - {
        "net", "state", "phi0", "n_iters"}


def validate_run_opts(opts: Optional[dict], supported, context: str,
                      reserved=()) -> dict:
    """Reject unsupported or reserved `run_opts` keys loudly; returns a
    copy of `opts` safe to ** into the driver."""
    opts = dict(opts or {})
    clash = set(opts) & set(reserved)
    if clash:
        raise ValueError(
            f"run_opts {sorted(clash)} are set by {context} itself — "
            "pass them through its own arguments instead")
    unknown = set(opts) - set(supported)
    if unknown:
        raise ValueError(
            f"run_opts {sorted(unknown)} are not supported by {context}; "
            f"supported keys: {sorted(set(supported) - set(reserved))}")
    return opts


def run(net: CECNetwork, phi0, n_iters: int = 200, variant: str = "sgp",
        beta: float = 1.0, allowed_data=None, allowed_result=None,
        min_scale: float = 0.05, method: str = "dense",
        rng: Optional[torch.Generator] = None, async_frac: float = 0.0,
        tol: float = 0.0, callback=None, use_blocking: bool = True,
        refresh_every: int = 20, scaling: str = "adaptive",
        kappa: float = 0.0, driver: Optional[str] = None,
        bucketed: bool = False, nbrs: Optional[Neighbors] = None,
        buckets=None, fault_plan=None,
        fault_rng: Optional[torch.Generator] = None, guards=None):
    """Algorithm 1 from φ⁰ for `n_iters` iterations (or until σ blows up
    or the tol exit fires): `init_run_state` and one `run_chunk`.

    The options are the reference's (`run_chunk` documents the drivers):
    method "dense" | "broadcast" | "sparse" (the flow model's engines;
    the sparse one iterates in slots); variant "sgp" | "gp" (Gallager's
    rule, step β); allowed_* dense
    permission masks of restricted baselines; use_blocking=False skips
    the taint protocol; scaling "adaptive" (current-flow curvature × σ,
    uphill steps rejected) | "paper" (Eq. 16 verbatim, κ = 1, its sups
    refreshed from the current cost every `refresh_every` iterations);
    κ > 0 adds Eq. 16's cross terms; async_frac > 0 updates a random
    share of the rows each iteration, drawn from the generator `rng` on
    the network's device.  bucketed=True (sparse engine) runs every
    recursion over degree buckets, bit for bit the padded trajectory.
    `nbrs` and `buckets` take tiles already built.  `fault_plan`
    (`faults.FaultPlan`, drawing from the generator `fault_rng`) arms
    the fault injectors and `guards` (`guards.GuardConfig`) the
    sentinels and rollback; either runs the fused driver, and the
    history then also carries "guard_events" / "n_corrupt".  A dense
    `Phi` in gives a dense `Phi` back, a `PhiSparse` a `PhiSparse`.
    Returns (phi_final, {"costs", "final_cost", "n_rejected"})."""
    dense_in = not isinstance(phi0, PhiSparse)
    state = init_run_state(net, phi0, min_scale=min_scale, method=method,
                           rng=rng, nbrs=nbrs, bucketed=bucketed,
                           buckets=buckets, fault_plan=fault_plan,
                           fault_rng=fault_rng, guards=guards)
    state = run_chunk(net, state, n_iters, variant=variant, beta=beta,
                      allowed_data=allowed_data,
                      allowed_result=allowed_result, async_frac=async_frac,
                      tol=tol, callback=callback, use_blocking=use_blocking,
                      refresh_every=refresh_every, scaling=scaling,
                      kappa=kappa, driver=driver)
    phi = state.phi
    if method == "sparse" and dense_in:
        phi = sparse_to_phi(phi, state.nbrs, net.V)
    hist = {"costs": state.costs, "final_cost": state.costs[-1],
            "n_rejected": state.n_rejected}
    if guards is not None:
        hist["guard_events"] = state.guard_events
    if state.fault_state is not None:
        hist["n_corrupt"] = int(state.fault_state.n_corrupt)
    return phi, hist
