"""Algorithm 1 on the sparse edge-slot engine (PyTorch port)."""
from .costs import SAT, Cost, CostFamily, FAMILIES
from .marginals import BIG, Marginals, compute_marginals
from .network import (DENSE_V_LIMIT, CECNetwork, EdgeBuckets, Flows,
                      FlowsCarry, NeighborBuckets, Neighbors, Phi, PhiSparse,
                      as_dense_phi, build_buckets, build_neighbors,
                      compute_flows, cost_of_carry, flows_carry_and_cost,
                      gather_edges, link_cost_sparse, mask_slots,
                      offload_phi, phi_to_sparse, resolve_device,
                      scatter_edges, solve_downstream_sparse, sparse_to_phi,
                      spt_phi, spt_phi_sparse, spt_result_slots,
                      uniform_phi)
from .scenarios import TABLE_II, ScenarioSpec, enforce_feasibility, make_scenario
from .sgp import (SIGMA_DECAY, FusedStream, SGPConsts, RunState,
                  accept_step, blocked_sets_sparse, gp_rows, init_run_state,
                  make_consts, run, run_chunk, run_opt_keys,
                  validate_run_opts)
from . import topologies

__all__ = [
    "SAT", "Cost", "CostFamily", "FAMILIES", "BIG", "Marginals",
    "compute_marginals", "DENSE_V_LIMIT", "CECNetwork", "EdgeBuckets",
    "Flows", "FlowsCarry", "NeighborBuckets", "Neighbors", "Phi",
    "PhiSparse", "as_dense_phi", "build_buckets", "build_neighbors",
    "compute_flows", "cost_of_carry", "flows_carry_and_cost",
    "gather_edges", "link_cost_sparse", "mask_slots", "offload_phi",
    "phi_to_sparse", "resolve_device", "scatter_edges",
    "solve_downstream_sparse", "sparse_to_phi", "spt_phi",
    "spt_phi_sparse", "spt_result_slots", "uniform_phi", "TABLE_II",
    "ScenarioSpec", "enforce_feasibility", "make_scenario", "SIGMA_DECAY",
    "FusedStream", "SGPConsts", "RunState", "accept_step",
    "blocked_sets_sparse", "gp_rows", "init_run_state", "make_consts",
    "run", "run_chunk", "run_opt_keys", "validate_run_opts", "topologies",
]
