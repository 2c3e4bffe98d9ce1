"""Algorithm 1 and the paper's evaluation (PyTorch port)."""
from .costs import SAT, Cost, CostFamily, FAMILIES
from .marginals import BIG, Marginals, compute_marginals, phi_gradients
from .network import (DENSE_V_LIMIT, CECNetwork, EdgeBuckets,
                      Flows, FlowsCarry, NeighborBuckets, Neighbors, Phi,
                      PhiSparse, as_dense_phi, build_buckets,
                      build_neighbors, compute_flows, cost_of_carry,
                      cost_of_flows, flows_carry, flows_carry_and_cost,
                      gather_edges, is_loop_free, link_cost_sparse,
                      mask_slots, offload_phi, phi_to_sparse, refeasibilize,
                      resolve_device, scatter_edges, solve_downstream_sparse,
                      sparse_to_phi, spt_phi, spt_phi_sparse,
                      spt_result_slots, support_matrices, total_cost,
                      uniform_phi)
from .scenarios import (TABLE_II, ScenarioSpec, churn_hub,
                        enforce_feasibility, fail_node, hub_node,
                        make_scenario)
from .sgp import (SIGMA_DECAY, FusedStream, SGPConsts, RunState,
                  accept_step, blocked_sets, blocked_sets_sparse, gp_rows,
                  init_run_state, make_consts, project_rows, run, run_chunk,
                  run_opt_keys, validate_run_opts)
from .baselines import run_all, run_lcor, run_lpr, run_spoo
from .optimality import (flow_domain_optimum, marginals_vs_autodiff,
                         theorem1_residual)
from . import topologies

__all__ = [
    "SAT", "Cost", "CostFamily", "FAMILIES", "BIG", "Marginals",
    "compute_marginals", "phi_gradients", "DENSE_V_LIMIT",
    "CECNetwork", "EdgeBuckets", "Flows", "FlowsCarry", "NeighborBuckets",
    "Neighbors", "Phi", "PhiSparse", "as_dense_phi", "build_buckets",
    "build_neighbors", "compute_flows", "cost_of_carry", "cost_of_flows",
    "flows_carry", "flows_carry_and_cost", "gather_edges", "is_loop_free",
    "link_cost_sparse", "mask_slots", "offload_phi", "phi_to_sparse",
    "refeasibilize", "resolve_device", "scatter_edges",
    "solve_downstream_sparse", "sparse_to_phi", "spt_phi",
    "spt_phi_sparse", "spt_result_slots", "support_matrices", "total_cost",
    "uniform_phi", "TABLE_II", "ScenarioSpec", "churn_hub",
    "enforce_feasibility", "fail_node", "hub_node", "make_scenario",
    "SIGMA_DECAY", "FusedStream", "SGPConsts", "RunState", "accept_step",
    "blocked_sets", "blocked_sets_sparse", "gp_rows", "init_run_state",
    "make_consts", "project_rows", "run", "run_chunk", "run_opt_keys",
    "validate_run_opts", "run_all", "run_lcor", "run_lpr", "run_spoo",
    "flow_domain_optimum", "marginals_vs_autodiff", "theorem1_residual",
    "topologies",
]
